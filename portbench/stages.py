"""The port's stages on the card's timeline: a study of the traced window
(not part of a run), and the interval arithmetic of the stage metrics.

The port opens a ``torch.profiler`` range ``raft.<stage>`` around each
stage of its serving path (``raft.validate``, ``raft.pad``,
``raft.copy_in``, ``raft.replay``, ``raft.copy_out``, ``raft.upload``,
``raft.tick``, ``raft.unpad``) and of its eager forward (``raft.encode``,
``raft.loop``, ``raft.epilogue``, which the profiler mirrors onto the
card's timeline; a CUDA graph's replay opens none). Two records of a
traced window read them:

- ``busy_intervals``: the card's merged busy intervals inside the window,
  in ns;
- ``ranges``: each ``raft.*`` range overlapping the window as ``(name,
  start_ns, end_ns, on_device)``, clipped to it.

:class:`StageProfile` is ``trace.Profile`` recording every thread of the
host (the serving threads open their ranges outside the main thread) whose
``reduce()`` adds those two keys to the ones ``trace.Profile.reduce()``
returns, and keeps a table of the stages. The readers of
``prep_idle_share`` and ``{encode,loop,epilogue}_ms_per_frame``
(``metrics/``) read the two keys.

``python -m portbench.stages --workload <cell> --seeds <n,n,...> --seconds
<s>`` runs the cell once a seed, traced as ``portbench.run --trace 1`` runs
it but under :class:`StageProfile`, and prints one JSON line a seed: the
run's per-layer metrics, the stage metrics, the table, and the offset
between each request's ``pad`` and ``validate`` spans in the ``RAFT_TRACE``
sink, mapped through the timeline's ``clock`` pair, and the nearest range
of the same stage.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from portbench import trace

PREP = ("raft.validate", "raft.pad", "raft.copy_in", "raft.upload")
HOST_STAGES = PREP + ("raft.replay", "raft.copy_out", "raft.unpad")
MODEL_STAGES = ("raft.encode", "raft.loop", "raft.epilogue")

Interval = Tuple[float, float]


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the intersection of two merged, sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(intervals: Iterable[Interval], busy: Sequence[Interval]) -> float:
    """ns of the union of ``intervals`` that no busy interval covers."""
    union = trace.merged(intervals)
    return sum(e - s for s, e in union) - overlap_ns(union, busy)


def busy_under(intervals: Iterable[Interval], busy: Sequence[Interval]) -> float:
    """ns of the union of ``intervals`` that the busy intervals cover."""
    return overlap_ns(trace.merged(intervals), busy)


def busy_ms_per_frame(name: str):
    """A reader: the card's busy ms inside the device-side ``name`` ranges
    over the window's frames."""
    def read(rec) -> Optional[float]:
        busy, ranges = rec.get("busy_intervals"), rec.get("ranges")
        if not busy or not ranges or not rec.get("frames"):
            return None
        dev = [(s, e) for n, s, e, on_device in ranges if n == name and on_device]
        return busy_under(dev, busy) / 1e6 / rec["frames"] if dev else None
    return read


def window_records(events, cuda_type) -> Tuple[Interval, List[list], List[list]]:
    """The window, the device's work and the ``raft.*`` ranges of a list of
    kineto events (``(start, end, name)`` and ``(name, start, end,
    on_device)``, unclipped)."""
    window, device, ranges = None, [], []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        on_device = e.device_type() == cuda_type
        if name.startswith("raft."):
            ranges.append([name, start, end, on_device])
        elif on_device:
            if not e.is_user_annotation():
                device.append([start, end, name])
        elif name == trace.WINDOW:
            window = (start, end)
    if window is None:
        raise RuntimeError(f"the trace holds no {trace.WINDOW} range")
    return window, device, ranges


def _inside(items, t0: float, t1: float, s: int, e: int):
    return [[*x[:s], max(x[s], t0), min(x[e], t1), *x[e + 1:]]
            for x in items if x[e] > t0 and x[s] < t1]


def _overlap_each(events: Sequence[list], union: Sequence[Interval]) -> float:
    """Summed overlap of each ``(start, end, ...)`` event with a merged
    interval list."""
    starts = [s for s, _ in union]
    total = 0.0
    for ev in events:
        k = max(bisect.bisect_right(starts, ev[0]) - 1, 0)
        while k < len(union) and union[k][0] < ev[1]:
            total += max(0.0, min(ev[1], union[k][1]) - max(ev[0], union[k][0]))
            k += 1
    return total


def stage_table(busy: Sequence[Interval], device: Sequence[list], ranges: Sequence[list],
                t0: float, t1: float) -> Dict[str, dict]:
    """Seconds of the window by stage: ``idle_s`` of the card under each
    host stage's ranges (a stage on several threads counted once; stages
    overlap one another, ``any`` is under their union, ``none`` under
    none of them); ``model`` the card's busy seconds inside each
    device-side model range, and the seconds of the ``other`` group's
    kernels (``trace.group_of``) among them."""
    idle_total = (t1 - t0) - sum(e - s for s, e in busy)
    host = {n: [(s, e) for name, s, e, d in ranges if name == n and not d]
            for n in HOST_STAGES}
    idle = {n.split(".")[1]: idle_under(iv, busy) / 1e9 for n, iv in host.items()}
    any_s = idle_under([iv for ivs in host.values() for iv in ivs], busy) / 1e9
    idle.update(any=any_s, none=idle_total / 1e9 - any_s, total=idle_total / 1e9)
    other = [d for d in device if trace.group_of(d[2]) == "other"]
    model = {}
    covered = []
    for n in MODEL_STAGES:
        union = trace.merged((s, e) for name, s, e, d in ranges if name == n and d)
        covered += union
        model[n.split(".")[1]] = {"busy_s": overlap_ns(union, busy) / 1e9,
                                  "other_s": _overlap_each(other, union) / 1e9}
    all_other = sum(e - s for s, e, _ in other)
    model["outside"] = {
        "busy_s": (sum(e - s for s, e in busy) - overlap_ns(trace.merged(covered), busy)) / 1e9,
        "other_s": (all_other - _overlap_each(other, trace.merged(covered))) / 1e9}
    return {"idle_s": idle, "model": model}


def clock_offsets(sink: str, ranges: Sequence[list], kinds=("pad", "validate")) -> dict:
    """For each window request of the ``RAFT_TRACE`` sink (ids from ``w``),
    each span of ``kinds`` mapped through the timeline's ``clock`` pair,
    against the start of the nearest host range ``raft.<kind>``: ms."""
    starts = {k: sorted(s for n, s, _, d in ranges if n == f"raft.{k}" and not d)
              for k in kinds}
    out: Dict[str, List[float]] = {k: [] for k in kinds}
    with open(sink) as f:
        for line in f:
            doc = json.loads(line)
            clock = doc.get("clock")
            if clock is None or not str(doc.get("request_id", "")).startswith("w"):
                continue
            for sp in doc["spans"]:
                got = starts.get(sp["kind"])
                if not got:
                    continue
                t = clock["epoch_ns"] + (sp["t0"] - clock["monotonic"]) * 1e9
                k = bisect.bisect_left(got, t)
                near = min((abs(got[j] - t) for j in (k - 1, k) if 0 <= j < len(got)))
                out[sp["kind"]].append(near / 1e6)
    return {k: {"n": len(v), "median_ms": statistics.median(v), "max_ms": max(v)}
            for k, v in out.items() if v}


class StageProfile(trace.Profile):
    """``trace.Profile`` over every thread of the host, whose ``reduce()``
    adds ``busy_intervals`` and ``ranges`` and keeps the stage table
    (``table``) and the clock offsets (``offsets``). ``last`` is the
    newest one started."""

    last: Optional["StageProfile"] = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        self._prof = profile(activities=acts, experimental_config=config)
        self._prof.start()
        StageProfile.last = self

    def reduce(self) -> Optional[dict]:
        out = super().reduce()
        if out is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        (t0, t1), device, ranges = window_records(events, torch.autograd.DeviceType.CUDA)
        device = _inside(device, t0, t1, 0, 1)
        ranges = _inside(ranges, t0, t1, 1, 2)
        busy = trace.merged((s, e) for s, e, _ in device)
        out["busy_intervals"] = busy
        out["ranges"] = [tuple(r) for r in ranges]
        self.table = stage_table(busy, device, ranges, t0, t1)
        sink = os.environ.get("RAFT_TRACE")
        self.offsets = clock_offsets(sink, ranges) if sink and os.path.exists(sink) else {}
        self.record = out
        return out


STAGE_METRICS = ("validate_ms", "copy_in_ms", "prep_idle_share", "encode_ms_per_frame",
                 "loop_ms_per_frame", "epilogue_ms_per_frame")


def measure(cell: str, seed: int, seconds: float, *, device: str = "cuda",
            overrides: Optional[dict] = None) -> dict:
    """One traced run of ``cell`` under :class:`StageProfile`: its line's
    per-layer metrics, the stage metrics, the table and the clock offsets,
    the table's seconds also per frame in ms."""
    from portbench import harness, spec
    base, trace.Profile = trace.Profile, StageProfile
    try:
        line = harness.run(cell, seed, seconds, True, device=device, overrides=overrides)
    finally:
        trace.Profile = base
    prof = StageProfile.last
    frames = line["attempted"] - line["failed"]
    rec = {**prof.record, "frames": frames}
    stage = {m: line["metrics"].get(m, {}).get("value") for m in STAGE_METRICS}
    for m in ("prep_idle_share", "encode_ms_per_frame", "loop_ms_per_frame",
              "epilogue_ms_per_frame"):
        stage[m] = spec.metric_reader(m)(rec)
    per_frame = {"idle_ms": {k: 1e3 * v / frames for k, v in prof.table["idle_s"].items()},
                 "model_ms": {k: {kk: 1e3 * vv / frames for kk, vv in v.items()}
                              for k, v in prof.table["model"].items()}} if frames else {}
    return {"workload": cell, "seed": seed, "correct": line["correct"], "frames": frames,
            "window_s": prof.record["window_s"], "busy_s": prof.record["busy_s"],
            "metrics": {k: v["value"] for k, v in line["metrics"].items()},
            "stage_metrics": stage, "per_frame": per_frame, "clock_offsets": prof.offsets}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(measure(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
