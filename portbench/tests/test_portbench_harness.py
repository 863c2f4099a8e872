"""CPU tests of the benchmark's harness: resolution by name, extension by new
files alone, the arithmetic of its metrics, a rehearsal of every cell at a
tiny size with the kernels' plain versions, the reference against the port's
plain path, and what a run may import.

Run: ``python -m pytest portbench/tests -q`` (the card's tests, marked
``gpu``: ``python -m pytest portbench/tests -m gpu`` on the card).
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import costs, harness, spec, trace

REPO = Path(__file__).resolve().parents[2]
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# A tiny rehearsal: every width cut, a small frame, a second's window.
TINY = {"config": {"hidden_dims": [32, 32, 32], "corr_levels": 2, "corr_radius": 2,
                   "valid_iters": 4},
        "traffic": {"height": 60, "width": 90, "pool": 2, "check_answers": 2,
                    "warmup_frames": 1, "warmup_requests": 1}}
RUN_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _env(pythonpath: str) -> dict:
    return {**os.environ, "PYTHONPATH": pythonpath, "OMP_NUM_THREADS": "2"}


def _rehearse(cell: str, traced: bool, cwd: Path, pythonpath: str,
              overrides: dict = TINY) -> dict:
    """A CPU run of ``cell`` in a fresh process: its result line, and the
    forbidden modules the process held after it."""
    code = ("import json, sys; from portbench import harness; "
            f"line = harness.run({cell!r}, 2**31 + 5, 1.0, {traced}, device='cpu', "
            f"overrides={overrides!r}); "
            "print(json.dumps({'line': line, 'forbidden': harness.forbidden_modules()}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=_env(pythonpath),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cells_resolve_by_name():
    for w in BENCH["workloads"]:
        cfg = spec.config(w["config"])
        tr = spec.traffic(w["traffic"])
        assert spec.driver(tr["driver"]).Runner
        assert spec.limits(w["name"])
        assert cfg["reduced"] == []
        for trace_on in (False, True):
            for m in spec.cell_metrics(BENCH, w["name"], trace_on):
                assert callable(spec.metric_reader(m["name"]))
    files = {c["name"]: c["file"] for c in BENCH["configs"]}
    for name, path in files.items():
        assert spec.config(name) == json.loads((REPO / path).read_text())


def _tree_hashes(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_driver_metric_by_new_files_alone(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _tree_hashes(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "raftstereo-middlebury.json").read_text())
    (pb / "configs" / "throwaway-model.json").write_text(
        json.dumps({**cfg, "n_gru_layers": 2, "valid_iters": 4}))
    (pb / "traffic" / "throwaway_mix.json").write_text(json.dumps(
        {"driver": "throwaway_driver", "height": 64, "width": 96, "pool": 2,
         "max_disp": 8, "warmup_frames": 1, "check_answers": 2}))
    (pb / "drivers" / "throwaway_driver.py").write_text(
        "from portbench.drivers.frames import Runner as _Frames\n\n\n"
        "class Runner(_Frames):\n    pass\n")
    (pb / "metrics" / "throwaway.count.py").write_text(
        "def read(rec):\n    return float(rec['frames'])\n")
    (pb / "limits" / "throwaway.cell.json").write_text(json.dumps({"mean_abs_px": 1.0}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway-model", "source": "https://example.org",
                             "file": "portbench/configs/throwaway-model.json",
                             "reduced": [], "why": "a test's"})
    bench["workloads"].append({"name": "throwaway.cell", "config": "throwaway-model",
                               "traffic": "throwaway_mix", "chips": 1, "why": "a test's"})
    bench["per_layer"].append({"name": "throwaway.count", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "entry", "moves": "fps",
                               "workloads": ["throwaway.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    tiny = {"config": {"hidden_dims": [32, 32, 32], "corr_levels": 2, "corr_radius": 2},
            "traffic": {}}
    got = _rehearse("throwaway.cell", True, tmp_path, f"{tmp_path}:{REPO}", tiny)
    line = got["line"]
    assert line["metrics"]["throwaway.count"]["value"] == line["attempted"] > 0
    assert line["correct"] is True
    after = _tree_hashes(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_busy_union_and_idle_gaps():
    ns = 1e9
    intervals = [(0, 2 * ns), (1 * ns, 3 * ns), (5 * ns, 6 * ns), (5.5 * ns, 5.6 * ns)]
    assert trace.busy_seconds(intervals) == pytest.approx(4.0)
    busy = trace.merged(intervals)
    assert busy == [(0, 3 * ns), (5 * ns, 6 * ns)]
    gaps = trace.idle_gaps(busy, -1 * ns, 10 * ns)
    assert gaps == [(6 * ns, 10 * ns), (3 * ns, 5 * ns), (-1 * ns, 0)]
    host = [(2.5 * ns, 5.5 * ns, "long"), (3 * ns, 4.9 * ns, "short"),
            (3 * ns, 5 * ns, "exact")]
    assert trace.name_gaps(gaps[1:2], host) == [["exact", 2.0]]
    assert trace.name_gaps(gaps[:1], host) == [["no host operation", 4.0]]
    assert trace.group_of("void resident_kernel<bf16>") == "fused_iter"
    assert trace.group_of("sm90_xmma_gemm_bf16") == "matmul"
    assert trace.group_of("elementwise_kernel") == "other"


def test_p95_over_every_request():
    read = spec.metric_reader("p95_ms")
    assert read({"latencies_ms": list(range(100, 0, -1))}) == 95
    assert read({"latencies_ms": [5.0] * 19 + [1000.0]}) == 5.0
    assert read({"latencies_ms": [5.0] * 19 + [1000.0] * 2}) == 1000.0
    assert read({"latencies_ms": None}) is None


def test_mfu_roofline_and_rate_arithmetic():
    cfg = {**spec.config("raftstereo-middlebury")}
    rec = {"config": cfg, "padded": (384, 1248), "frames": 20, "wall_s": 2.0,
           "window_s": 2.5, "busy_s": 2.0, "flops_per_frame": 5e12,
           "ops": {"void resident_kernel<bf16>": 0.02, "gru1632_kernel": 0.01, "x": 1.0}}
    assert spec.metric_reader("fps")(rec) == 10.0
    assert spec.metric_reader("mfu")(rec) == pytest.approx(100 * 20 * 5e12 / 2.5 / 989e12)
    assert spec.metric_reader("idle_share")(rec) == pytest.approx(20.0)
    assert spec.metric_reader("device_ms_per_frame")(rec) == pytest.approx(100.0)
    # The counts at the KITTI 96x312 level, as chip_smoke.py bounds them:
    # resident 0.112 ms (operations), gru16+32 0.0234 ms (operations).
    arch = costs.arch_of(cfg)
    assert costs.bound_s(*costs.resident_cost(arch, 96, 312)) == pytest.approx(1.12e-4, rel=0.01)
    assert costs.bound_s(*costs.gru1632_cost(arch, 96, 312)) == pytest.approx(2.34e-5, rel=0.01)
    res = spec.metric_reader("resident_roofline")(rec)
    want = 100 * 20 * 32 * costs.bound_s(*costs.resident_cost(arch, 96, 312)) / 0.02
    assert res == pytest.approx(want)
    gru = spec.metric_reader("gru1632_roofline")(rec)
    assert gru == pytest.approx(100 * 20 * 32 * costs.bound_s(*costs.gru1632_cost(arch, 96, 312))
                                / 0.01)
    assert spec.metric_reader("resident_roofline")({**rec, "ops": {}}) is None
    rt = {**rec, "config": spec.config("raftstereo-realtime")}
    assert spec.metric_reader("gru1632_roofline")(rt) is None


def test_frame_flops_on_meta():
    arch = costs.arch_of(spec.config("raftstereo-realtime"))
    f7 = costs.frame_flops(arch, 7, 384, 1248)
    f6 = costs.frame_flops(arch, 6, 384, 1248)
    assert 0.3e12 < f7 < 0.6e12 and f6 < f7


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_rehearses_on_cpu(cell, traced):
    got = _rehearse(cell, traced, REPO, str(REPO))
    line = got["line"]
    assert list(line)[:5] == list(RUN_KEYS) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == set(spec.limits(cell))
    names = {m["name"] for m in spec.cell_metrics(BENCH, cell, traced)}
    assert set(line["metrics"]) <= names
    if not traced:
        # A CPU run measures no device, so the peak is not reported.
        assert "setup_s" in line["metrics"] and "peak_mem_gib" not in line["metrics"]
        assert {"fps", "served_fps"} & set(line["metrics"])
    else:
        assert line["device"]["busy_s"] is None and "breakdown" in line
    json.dumps(line, allow_nan=False)
    assert got["forbidden"] == []


def test_reference_agrees_with_the_ports_plain_path():
    from portbench import inputs
    from portbench.reference import raft_stereo as ref
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.demo import infer_pair
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.transplant import load_state_dict
    torch.manual_seed(0)
    for name in ("raftstereo-middlebury", "raftstereo-realtime"):
        arch = costs.arch_of(spec.config(name))
        weights = inputs.make_weights(arch, 3, "cpu")
        (left, right), = inputs.make_pairs(1, 50, 100, 8.0, 4, "cpu")
        model = ref.RAFTStereo(arch)
        model.load_state_dict(weights)
        want = ref.disparity(model.eval(), left, right, 4).numpy()
        port = RAFTStereo(RAFTStereoConfig(corr_implementation="reg", **arch)).eval()
        load_state_dict(port, weights)
        got = infer_pair(port, left.float()[None], right.float()[None], iters=4).numpy()
        assert got.shape == want.shape == (50, 100)
        assert np.abs(got - want).max() < 1e-3, name
        assert np.abs(want).mean() > 0.05


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raft_stereo_tpu_torch_like", object())
    assert "raft_stereo_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "raft_stereo_tpu.models", object())
    assert "raft_stereo_tpu" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_port():
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("raft_stereo_tpu_torch", "raft_stereo_tpu",
                                                  "jax", "jaxlib", "flax"), (path, name)


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "kitti.cam1",
                          "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         env=_env(str(REPO)), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_cli_fails_with_only_the_benchmark(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "kitti.cam1",
                          "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
