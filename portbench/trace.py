"""The traced run's device record: ``torch.profiler`` over the window, read
into a few numbers.

The window is the ``portbench.window`` range the driver opens around its
timed loop. From the profile it reads:

- ``busy_s``: the union of the card's busy intervals (kernels, copies,
  fills) inside the window, overlapping launches counted once (the
  arithmetic of the port's ``obs/profiler.py:busy_seconds``, copied);
- ``ops``: device seconds inside the window by kernel name;
- the breakdown: device seconds by group (the groups of the port's
  ``chip_smoke.py`` ``EVENT_GROUPS``), and the longest idle gaps, each named
  by the host operation that overlapped it most.

Events are read straight from the profiler's kineto results, so that
hundreds of thousands of events are read in seconds.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "portbench.window"

# A hand-written kernel's device name, by the port's launch counter.
OWN_KERNELS = {"conv_gru": "loop_conv_kernel", "fused_iter": "resident_kernel",
               "gru1632": "gru1632_kernel", "motion": "motion_stage1_kernel",
               "enc_stem": "stem_sm90_kernel", "enc_pass": "pass_sm90_kernel",
               "enc_point3": "point3_kernel", "enc_point2": "point2_kernel",
               "corr_lookup": "corr_lookup_kernel", "corr_alt": "corr_alt_"}
# Device events by kind: the first group whose name part a kernel's name holds.
GROUPS = (("memcpy_htod", ("Memcpy HtoD",)), ("memcpy_dtoh", ("Memcpy DtoH",)),
          ("memcpy_dtod", ("Memcpy DtoD",)), ("memset", ("Memset",)),
          *((k, (v,)) for k, v in OWN_KERNELS.items()),
          ("matmul", ("gemm", "cutlass", "xmma", "cublas")),
          ("conv", ("conv", "cudnn", "implicit", "winograd")))
TOP = 10


def busy_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals in ns."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def group_of(name: str) -> str:
    return next((g for g, parts in GROUPS if any(p in name for p in parts)), "other")


def idle_gaps(busy: List[Tuple[float, float]], t0: float, t1: float
              ) -> List[Tuple[float, float]]:
    """The gaps of [t0, t1] that no busy interval covers, longest first."""
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, min(s, t1)))
        at = max(at, e)
    if at < t1:
        gaps.append((at, t1))
    return sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])


def name_gaps(gaps, host: List[Tuple[float, float, str]]) -> List[list]:
    """Each gap named by the host operation that overlapped it most (the
    shortest of equal ones), with its seconds."""
    if not host:
        return [["no host operation", (g1 - g0) / 1e9] for g0, g1 in gaps]
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    out = []
    for g0, g1 in gaps:
        overlap = np.clip(np.minimum(ends, g1) - np.maximum(starts, g0), 0, None)
        best = float(overlap.max())
        if best <= 0:
            out.append(["no host operation", (g1 - g0) / 1e9])
            continue
        cands = np.flatnonzero(overlap == best)
        pick = cands[np.argmin((ends - starts)[cands])]
        out.append([host[pick][2], (g1 - g0) / 1e9])
    return out


class Profile:
    """``torch.profiler`` around a run's window, off unless ``enabled``."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self._prof = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.start()

    def stop(self) -> None:
        if self._prof is not None:
            if self.cuda:
                torch.cuda.synchronize()
            self._prof.stop()

    @contextlib.contextmanager
    def window(self):
        """The range a driver opens around its timed loop."""
        with torch.profiler.record_function(WINDOW):
            yield

    def reduce(self) -> Optional[dict]:
        """``window_s``, ``busy_s`` (None without device events), ``ops``
        (device seconds by kernel name) and ``breakdown`` of the window."""
        if self._prof is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        window, device, host = None, [], []
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if e.device_type() == cuda:
                # Ranges of record_function are mirrored onto the device's
                # timeline; they are no device work.
                if not e.is_user_annotation():
                    device.append((start, end, name))
            elif name == WINDOW:
                window = (start, end)
            else:
                host.append((start, end, name))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        t0, t1 = window
        inside = [(max(s, t0), min(e, t1), n) for s, e, n in device if e > t0 and s < t1]
        ops: Dict[str, float] = defaultdict(float)
        for s, e, n in inside:
            ops[n] += (e - s) / 1e9
        groups: Dict[str, float] = defaultdict(float)
        for n, sec in ops.items():
            groups[group_of(n)] += sec
        busy = merged((s, e) for s, e, _ in inside)
        gaps = idle_gaps(busy, t0, t1)[:TOP]
        host_in = [h for h in host if h[1] > t0 and h[0] < t1]
        return {
            "window_s": (t1 - t0) / 1e9,
            "busy_s": busy_seconds(busy) if inside else None,
            "ops": dict(ops),
            "breakdown": {
                "device_ops": sorted(([g, s] for g, s in groups.items()),
                                     key=lambda x: -x[1])[:TOP],
                "idle_gaps": name_gaps(gaps, host_in) if inside else [],
            },
        }
