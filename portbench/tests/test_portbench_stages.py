"""CPU tests of the stage metrics and ``portbench/stages.py``: each reader on
a synthetic record (the union arithmetic of ``prep_idle_share`` where two
threads' ranges overlap), ``StageProfile.reduce()`` against
``trace.Profile.reduce()`` on a fixed event list, and a traced CPU run of
each served cell reporting ``validate_ms`` and ``copy_in_ms`` while the
device-derived readers give None.

Run: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import spec, stages, trace

REPO = Path(__file__).resolve().parents[2]
MS = 1e6  # ns


def _span(kind, ms, **attrs):
    return {"kind": kind, "ms": ms, **({"attrs": attrs} if attrs else {})}


def test_validate_ms_reads_the_validate_spans():
    read = spec.metric_reader("validate_ms")
    reqs = [{"spans": [_span("validate", v), _span("admission", 9.0)]} for v in (1.0, 3.0, 2.0)]
    assert read({"requests": reqs}) == 2.0
    # A program without the span (an older tree) reports nothing.
    assert read({"requests": [{"spans": [_span("admission", 1.0)]}]}) is None
    assert read({}) is None


def test_copy_in_ms_sums_the_split_and_the_upload():
    read = spec.metric_reader("copy_in_ms")
    fleet = {"spans": [_span("upload", 4.0), _span("prepare", 30.0, copy_in_ms=0.5),
                       _span("advance", 20.0, copy_in_ms=0.25),
                       _span("advance", 90.0, copy_in_ms=7.0, warming=True)]}
    cam = {"spans": [_span("full", 40.0, copy_in_ms=6.0)]}
    assert read({"requests": [fleet]}) == pytest.approx(4.75)
    assert read({"requests": [fleet, cam, cam]}) == pytest.approx(6.0)
    # Upload spans without the split (an older tree) report nothing.
    assert read({"requests": [{"spans": [_span("upload", 4.0), _span("full", 40.0)]}]}) is None


def test_prep_idle_share_counts_overlapping_threads_once():
    read = spec.metric_reader("prep_idle_share")
    busy = [(0, 10 * MS), (20 * MS, 30 * MS)]
    ranges = [("raft.validate", 5 * MS, 15 * MS, False),    # thread a: 5 idle
              ("raft.pad", 12 * MS, 18 * MS, False),        # thread b, overlaps a
              ("raft.copy_in", 17 * MS, 25 * MS, False),    # 17-20 idle
              ("raft.copy_out", 30 * MS, 40 * MS, False),   # no prep stage
              ("raft.pad", 0, 40 * MS, True)]               # device side: not the host's
    rec = {"busy_intervals": busy, "ranges": ranges, "window_s": 0.04}
    # Union of the host's prep ranges: 5-25 ms; idle inside it: 10-20 ms.
    assert read(rec) == pytest.approx(100.0 * 0.010 / 0.04)
    assert read({**rec, "ranges": ranges[3:]}) is None
    assert read({"window_s": 0.04, "busy_s": None}) is None


@pytest.mark.parametrize("name", ["encode", "loop", "epilogue"])
def test_model_stage_ms_per_frame(name):
    read = spec.metric_reader(f"{name}_ms_per_frame")
    busy = [(0, 4 * MS), (6 * MS, 10 * MS)]
    ranges = [(f"raft.{name}", 2 * MS, 8 * MS, True), (f"raft.{name}", 3 * MS, 5 * MS, True),
              (f"raft.{name}", 0, 10 * MS, False), ("raft.other", 0, 10 * MS, True)]
    rec = {"busy_intervals": busy, "ranges": ranges, "frames": 2}
    assert read(rec) == pytest.approx(2.0)  # busy 2-4 and 6-8 ms, over 2 frames
    assert read({**rec, "ranges": ranges[2:]}) is None
    assert read({"frames": 2}) is None


class _Event:
    def __init__(self, name, start, end, device=False, annotation=False):
        self._v = (name, int(start), int(end - start), device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]


EVENTS = [_Event(trace.WINDOW, 0, 100 * MS),
          _Event("void resident_kernel<bf16>", 2 * MS, 20 * MS, device=True),
          _Event("elementwise_kernel", 15 * MS, 30 * MS, device=True),
          _Event("elementwise_kernel", 50 * MS, 60 * MS, device=True),
          _Event("Memcpy HtoD (Pageable -> Device)", 95 * MS, 110 * MS, device=True),
          _Event("raft.encode", 1 * MS, 31 * MS, device=True, annotation=True),
          _Event("raft.loop", 49 * MS, 61 * MS, device=True, annotation=True),
          _Event("raft.pad", 30 * MS, 40 * MS),
          _Event("raft.copy_in", 35 * MS, 70 * MS),
          _Event("raft.validate", -5 * MS, 2 * MS),
          _Event("cudaMemcpyAsync", 35 * MS, 70 * MS),
          _Event("aten::pad", 30 * MS, 40 * MS)]


def _reduced(cls, monkeypatch):
    monkeypatch.delenv("RAFT_TRACE", raising=False)
    prof = cls(True, torch.device("cuda"))
    kineto = SimpleNamespace(events=lambda: list(EVENTS))
    prof._prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=kineto))
    return prof, prof.reduce()


def test_stage_profile_keeps_every_key_of_reduce(monkeypatch):
    _, base = _reduced(trace.Profile, monkeypatch)
    prof, got = _reduced(stages.StageProfile, monkeypatch)
    assert set(got) == set(base) | {"busy_intervals", "ranges"}
    for key in base:
        assert json.dumps(got[key], sort_keys=True) == json.dumps(base[key], sort_keys=True), key
    assert got["busy_intervals"] == [(2 * MS, 30 * MS), (50 * MS, 60 * MS), (95 * MS, 100 * MS)]
    assert sorted(got["ranges"]) == sorted([
        ("raft.encode", 1 * MS, 31 * MS, True), ("raft.loop", 49 * MS, 61 * MS, True),
        ("raft.pad", 30 * MS, 40 * MS, False), ("raft.copy_in", 35 * MS, 70 * MS, False),
        ("raft.validate", 0, 2 * MS, False)])
    idle = prof.table["idle_s"]
    assert idle["total"] == pytest.approx(0.057)
    assert idle["pad"] == pytest.approx(0.010) and idle["copy_in"] == pytest.approx(0.025)
    assert idle["validate"] == pytest.approx(0.002)
    assert idle["any"] == pytest.approx(0.032) and idle["none"] == pytest.approx(0.025)
    model = prof.table["model"]
    assert model["encode"]["busy_s"] == pytest.approx(0.028)
    assert model["encode"]["other_s"] == pytest.approx(0.015)
    assert model["loop"]["other_s"] == pytest.approx(0.010)
    assert model["outside"]["busy_s"] == pytest.approx(0.005)
    rec = {**got, "frames": 2}
    assert spec.metric_reader("prep_idle_share")(rec) == pytest.approx(32.0)
    assert spec.metric_reader("encode_ms_per_frame")(rec) == pytest.approx(14.0)
    assert spec.metric_reader("epilogue_ms_per_frame")(rec) is None


def test_clock_offsets_map_sink_spans_through_the_clock_pair(tmp_path):
    sink = tmp_path / "spans.jsonl"
    clock = {"monotonic": 100.0, "epoch_ns": 5_000_000_000}
    docs = [{"request_id": "w0-0", "clock": clock,
             "spans": [{"kind": "pad", "t0": 100.5}, {"kind": "validate", "t0": 100.25}]},
            {"request_id": "u0-0", "clock": clock, "spans": [{"kind": "pad", "t0": 90.0}]}]
    sink.write_text("".join(json.dumps(d) + "\n" for d in docs))
    ranges = [["raft.pad", 5_500_000_300, 5_600_000_000, False],
              ["raft.validate", 5_249_999_000, 5_250_000_000, False]]
    got = stages.clock_offsets(str(sink), ranges)
    assert got["pad"]["n"] == 1 and got["pad"]["max_ms"] == pytest.approx(0.0003)
    assert got["validate"]["median_ms"] == pytest.approx(0.001)


TINY = {"config": {"hidden_dims": [32, 32, 32], "corr_levels": 2, "corr_radius": 2,
                   "valid_iters": 4},
        "traffic": {"height": 60, "width": 90, "pool": 2, "check_answers": 2,
                    "warmup_frames": 1, "warmup_requests": 1}}


@pytest.mark.parametrize("cell", ["kitti.fleet8", "kitti.cam1"])
def test_served_cells_report_the_span_metrics_on_cpu(cell):
    code = ("import json; from portbench import stages; "
            f"print(json.dumps(stages.measure({cell!r}, 2**31 + 11, 1.0, device='cpu', "
            f"overrides={TINY!r})))")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    env.pop("RAFT_TRACE", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True and got["frames"] > 0
    for name in ("validate_ms", "copy_in_ms"):
        assert got["metrics"][name] > 0 and got["stage_metrics"][name] == got["metrics"][name]
    for name in ("prep_idle_share", "encode_ms_per_frame", "loop_ms_per_frame",
                 "epilogue_ms_per_frame"):
        assert got["stage_metrics"][name] is None, name
    assert got["clock_offsets"]["pad"]["max_ms"] < 1.0
