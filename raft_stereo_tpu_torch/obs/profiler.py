"""Profiler windows on ``torch.profiler``, and the device seconds of a trace.

:class:`ProfilerWindow` is the JAX package's guarded toggle
(``obs/profiler.py``) on ``torch.profiler``: the output directory comes
from ``RAFT_PROFILE_DIR`` (read at construction, never at import) or an
argument; with neither the window is disabled and ``start()`` is a counted
no-op. Windows are serialized (``start`` while one is open is refused) and
counted; each closed window writes a Chrome trace into the directory. A
window records every thread of the process (the serving session's worker,
scheduler and uploader threads open their ``raft.*`` ranges,
``obs/tracing.py``, outside the thread that opened the window).

:func:`device_seconds` reads a profile's device activity (kernels, copies
and fills on the card) as the union of their intervals: time in which the
card was busy, with overlapping launches counted once, not the sum of
their durations. A profile with no device events (the CPU) gives ``None``.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple


def _activities():
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class ProfilerWindow:
    def __init__(self, out_dir: Optional[str] = None):
        if out_dir is None:
            out_dir = os.environ.get("RAFT_PROFILE_DIR") or None
        self.out_dir = out_dir
        self._prof = None
        self._windows = 0
        self._refused = 0
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.out_dir is not None

    def start(self) -> bool:
        """Open a capture window. Returns False (and counts the refusal)
        when disabled or already open; never raises at the operator."""
        import torch
        from torch.profiler import profile
        with self._lock:
            if self.out_dir is None or self._prof is not None:
                self._refused += 1
                return False
            every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            self._prof = profile(activities=_activities(), experimental_config=every_thread)
            try:
                self._prof.start()
            except Exception:
                self._prof = None
                raise
        return True

    def stop(self) -> Optional[str]:
        """Close the window and write its Chrome trace; returns the trace's
        path (None if no window was open). The stop is claimed under the
        lock, so of two racing calls only one reaches the profiler."""
        with self._lock:
            prof, self._prof = self._prof, None
            if prof is None:
                return None
            n = self._windows
            self._windows += 1
        prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"trace-{os.getpid()}-{n}.json")
        prof.export_chrome_trace(path)
        return path

    @contextlib.contextmanager
    def window(self):
        opened = self.start()
        try:
            yield opened
        finally:
            if opened:
                self.stop()

    def status(self) -> Dict:
        with self._lock:
            return {"enabled": self.out_dir is not None, "dir": self.out_dir,
                    "active": self._prof is not None, "windows": self._windows,
                    "refused": self._refused}


def device_intervals(prof) -> List[Tuple[float, float]]:
    """(start, end) in µs of every device event of a finished profile."""
    import torch
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of µs intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def device_seconds(prof) -> Optional[float]:
    """The card's busy seconds in a finished profile; ``None`` when it holds
    no device event."""
    intervals = device_intervals(prof)
    return busy_seconds(intervals) if intervals else None


def profile_device_seconds(fn: Callable[[], object],
                           trace_path: Optional[str] = None) -> Optional[float]:
    """Run ``fn()`` under ``torch.profiler`` and return the card's busy
    seconds during it (:func:`device_seconds`), synchronizing before and
    after; with ``trace_path`` also write its Chrome trace there."""
    import torch
    from torch.profiler import profile
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=_activities()) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    return device_seconds(prof)
