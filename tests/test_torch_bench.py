"""The port's bench entry point (``python -m raft_stereo_tpu_torch.bench``)
on the CPU at a tiny size.

- ``main()`` in process at 64x128, 2 iterations, 1 frame, for the default
  and the realtime architecture: one JSON line with the JAX bench's keys,
  ``unit == "frames/s"``, ``value > 0``, a ``cpu`` metric name (with the
  architecture in it when overridden), flops counted, and every device
  number absent (``device_s``, ``mfu``, ``roofline``, ``peak_hbm_bytes``:
  never computed against a made-up peak).
- The CLI in a subprocess: ``--device cpu`` prints exactly one JSON line;
  without it, on a host without CUDA, it exits non-zero.
- Checksum pins: a bare run writes no pin file, ``RAFT_BENCH_AUTOPIN=1``
  records a missing pin and never moves one, an out-of-band checksum
  raises, ``RAFT_BENCH_REBASELINE=1`` moves it.
- ``corr_dma`` / ``lane_dma``: int8 over bf16 at most 0.6 at the bench's
  and the headline geometry.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from raft_stereo_tpu_torch import RAFTStereoConfig
from raft_stereo_tpu_torch import bench

REPO = Path(__file__).resolve().parents[1]
TINY = {"RAFT_BENCH_H": "64", "RAFT_BENCH_W": "128", "RAFT_BENCH_ITERS": "2",
        "RAFT_BENCH_FRAMES": "1"}
REALTIME = {"RAFT_BENCH_SHARED": "1", "RAFT_BENCH_DOWNSAMPLE": "3",
            "RAFT_BENCH_GRU_LAYERS": "2", "RAFT_BENCH_SLOW_FAST": "1"}
KEYS = {"metric", "value", "unit", "vs_baseline", "checksum", "sum_abs", "device_s", "flops",
        "mfu", "peak_hbm_bytes", "roofline", "bytes", "corr_dma", "lane_dma"}


@pytest.fixture(autouse=True)
def _bench_env(monkeypatch, tmp_path):
    """Tiny sizes, a scratch pin file, no pin switches."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    for knob in ("RAFT_BENCH_AUTOPIN", "RAFT_BENCH_REBASELINE", "RAFT_BENCH_TRACE", *REALTIME):
        monkeypatch.delenv(knob, raising=False)
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "PIN_PATH", tmp_path / "pins.json")
    yield
    torch.set_num_threads(n)


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("arch", [{}, REALTIME], ids=["default", "realtime"])
def test_bench_main_on_cpu(capsys, monkeypatch, tmp_path, arch):
    for k, v in arch.items():
        monkeypatch.setenv(k, v)
    bench.main(["--device", "cpu"])
    out = capsys.readouterr()
    lines = _json_lines(out.out)
    assert len(lines) == 1, out.out
    doc = lines[0]
    assert set(doc) == KEYS
    assert doc["unit"] == "frames/s" and doc["value"] > 0
    suffix = "_sh1_d3_g2_sf1" if arch else ""
    assert doc["metric"] == ("middlebury_F_disparity_fps_cpu_2iters_64x128_reg_cuda_bf16"
                             + suffix)
    assert doc["flops"] > 0
    for key in ("device_s", "mfu", "roofline", "bytes", "peak_hbm_bytes", "vs_baseline"):
        assert doc[key] is None, key
    assert not (tmp_path / "pins.json").exists()  # a bare run never writes
    assert "no pinned checksum for cpu:64x128_i2_reg_cuda_bf16_b1" + (suffix or "_sh0_d2_g3_sf0") \
        in out.err


def _cli(*args, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", **TINY, **env)
    return subprocess.run([sys.executable, "-m", "raft_stereo_tpu_torch.bench", *args],
                          cwd=REPO, env=full, capture_output=True, text=True, timeout=300)


def test_bench_cli_prints_one_json_line_and_needs_cuda_unless_asked(tmp_path):
    res = _cli("--device", "cpu", RAFT_BENCH_TRACE=str(tmp_path / "trace"))
    assert res.returncode == 0, res.stderr[-800:]
    lines = _json_lines(res.stdout)
    assert len(lines) == 1 and set(lines[0]) >= {"metric", "value", "unit", "vs_baseline"}
    assert (tmp_path / "trace" / "bench_frame.json").exists()
    if torch.cuda.is_available():
        return
    res = _cli()
    assert res.returncode != 0 and not _json_lines(res.stdout)
    assert "CUDA is not available" in res.stderr


def test_checksum_pins(tmp_path, monkeypatch):
    path = tmp_path / "pins.json"
    bench.check_checksum_pin("cuda:k", 100.0, 300.0, path)
    assert not path.exists()
    monkeypatch.setenv("RAFT_BENCH_AUTOPIN", "1")
    bench.check_checksum_pin("cuda:k", 100.0, 300.0, path)
    pinned = json.loads(path.read_text())["cuda:k"]
    assert pinned == {"checksum": 100.0, "sum_abs": 300.0, "rtol": 0.005, "atol": 1.0}
    bench.check_checksum_pin("cuda:k", 100.9, 301.4, path)  # in band, never moved
    assert json.loads(path.read_text())["cuda:k"] == pinned
    with pytest.raises(AssertionError, match="outside the pinned band"):
        bench.check_checksum_pin("cuda:k", 100.0, 302.0, path)
    monkeypatch.delenv("RAFT_BENCH_AUTOPIN")
    with pytest.raises(AssertionError, match="checksum"):
        bench.check_checksum_pin("cuda:k", 98.0, 300.0, path)
    monkeypatch.setenv("RAFT_BENCH_REBASELINE", "1")
    bench.check_checksum_pin("cuda:k", 98.0, 300.0, path)
    assert json.loads(path.read_text())["cuda:k"]["checksum"] == 98.0
    path.write_text("{not json")
    monkeypatch.delenv("RAFT_BENCH_REBASELINE")
    with pytest.raises(ValueError):  # an unreadable pin file is never reset
        bench.check_checksum_pin("cuda:k", 98.0, 300.0, path)


def test_committed_pins_are_card_pins():
    """Only card runs pin: each committed key is ``cuda:``-namespaced and
    holds both statistics in the 0.5% band."""
    committed = Path(bench.__file__).with_name("bench_checksum_ref.json")
    for key, ref in json.loads(committed.read_text()).items():
        assert key.startswith("cuda:"), key
        assert {"checksum", "sum_abs"} <= set(ref) and ref["rtol"] == bench.PIN_RTOL, key


@pytest.mark.parametrize("kw", [{}, dict(shared_backbone=True, n_downsample=3, n_gru_layers=2,
                                         slow_fast_gru=True)], ids=["default", "realtime"])
def test_dma_accounting(kw):
    cfg = RAFTStereoConfig(**kw)
    for h, w in ((384, 1248), (2016, 2976)):
        corr, lane = bench.corr_dma(cfg, h, w), bench.lane_dma(cfg, h, w)
        for doc in (corr, lane):
            assert doc["int8_over_bf16"] <= 0.6
            assert doc["int8_bytes_per_iter"] < doc["bf16_bytes_per_iter"]
    f = cfg.downsample_factor
    taps = cfg.corr_levels * (2 * cfg.corr_radius + 2)
    assert bench.corr_dma(cfg, 2016, 2976)["bf16_bytes_per_iter"] == \
        2 * taps * (2016 // f) * (2976 // f)
    # czrq: each level's (H, W, 3 * 128) bf16 context once a step; slow-fast
    # steps gru16 twice an iteration at 2 levels.
    steps = bench.gru_steps(cfg)
    assert steps == ((1, 2) if kw else (1, 1, 1))
    want = sum(n * 2 * (2016 // f >> i) * (2976 // f >> i) * 3 * 128
               for i, n in enumerate(steps))
    assert bench.lane_dma(cfg, 2016, 2976)["bf16_bytes_per_iter"] == want
