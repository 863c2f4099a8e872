"""Structured request tracing: where did this request's deadline go?

A copy of the JAX package's ``obs/tracing.py``, with ``RealClock`` from the
port's :mod:`raft_stereo_tpu_torch.faults`, the profiler ranges and the
clock pair below.

Every admitted request gets a trace id and a :class:`RequestTrace` — an
ordered span timeline recorded host-side at **program boundaries only**
(validate, admission, queue wait, pad, upload, prepare, each advance tick,
epilogue, unpad, plus degrade/breaker decision events; a program span
carries its copy-in, replay and copy-out times as attributes).  Spans never
reach inside a compiled program: the trace reads the session clock around
device calls,
so GV103 (no host callbacks in traced programs) stays clean by
construction and the tracer costs nothing on the device.

Two recording targets, both bounded:

- an in-memory **ring** of the last N completed timelines (the /healthz
  debugging surface — ``tracer.last()`` answers "show me the previous
  request's breakdown" without any sink configured);
- an optional **JSONL sink** (``RAFT_TRACE=/path/file.jsonl``, read once
  at tracer construction — never at import time): one line per completed
  request, append-only, consumable by ``scratch/analyze_trace.py``-style
  offline tooling.

Span accounting is split into **tiling** spans and **concurrent** spans.
Tiling spans advance the trace cursor and partition the request's wall
time (validate → admission → queue_wait → pad → prepare → advance… →
epilogue → unpad), so their summed durations reconcile with the reported
end-to-end latency — exactly (FakeClock) or up to scheduler-loop slack
(RealClock).  Concurrent spans
(the background upload that overlaps a running segment) and zero-duration
events (breaker trips, degrade decisions) are recorded in the timeline
but excluded from the reconciliation sum.

The clock is injected (``faults.RealClock``/``FakeClock``), so span
arithmetic in tests is deterministic and instantaneous.

**Profiler ranges.** :func:`stage` opens a ``raft.<name>`` range of
``torch.profiler`` around a stage of the program while a profiler is
collecting, and does nothing else when none is (one flag read). Each span
opened with :meth:`RequestTrace.span` is such a stage, and the serving path
wraps the stages inside its spans (``raft.validate``, ``raft.pad``,
``raft.copy_in``, ``raft.replay``, ``raft.copy_out``, ``raft.upload``,
``raft.tick``), as the model wraps its own (``raft.encode``,
``raft.loop``, ``raft.epilogue``). A range's first recorded input is the
request's trace number (``req-000017`` gives 17), or the scheduler tick's
``seq`` for the work of a batched call; the profiler keeps it when it
records shapes (``record_shapes=True``). A request's timeline ends with
``clock``: the session clock and the epoch clock (``time.time_ns()``,
which the profiler's events are on) read back to back when the trace
finishes (:func:`_clock_pair`), so a span's ``t0`` lies at ``epoch_ns +
(t0 - monotonic) * 1e9`` on the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from raft_stereo_tpu_torch.faults import RealClock

logger = logging.getLogger(__name__)

#: Default ring depth: enough recent timelines to debug a live incident,
#: bounded regardless of traffic.
DEFAULT_RING = 256


def _profiling() -> bool:
    """Whether a ``torch.profiler`` is collecting (in any thread): the
    Python flag the profiler sets, read without importing torch."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _range_id(trace, tick: Optional[int]) -> Optional[int]:
    if tick is not None:
        return int(tick)
    trace_id = getattr(trace, "trace_id", None)
    if isinstance(trace_id, str) and trace_id.startswith("req-"):
        return int(trace_id[4:])
    return None


def _clock_pair(clock) -> Dict:
    """The session clock read between two reads of the epoch clock, the
    tightest of three tries: a thread switch between the reads would
    shift every span of the timeline on the profiler's clock."""
    best = None
    for _ in range(3):
        e0 = time.time_ns()
        m = clock.now()
        e1 = time.time_ns()
        if best is None or e1 - e0 < best[0]:
            best = (e1 - e0, m, (e0 + e1) // 2)
    return {"monotonic": best[1], "epoch_ns": best[2]}


class stage:
    """``torch.profiler`` range ``raft.<name>`` around a block while a
    profiler is collecting; nothing but one flag read when none is. The
    range's input is the trace number of ``trace`` (a
    :class:`RequestTrace`), or ``tick`` (a scheduler tick's seq) when given.
    No range is opened while the current CUDA stream is being captured into
    a graph."""

    __slots__ = ("name", "trace", "tick", "_handle")

    def __init__(self, name: str, trace=None, tick: Optional[int] = None):
        self.name = name
        self.trace = trace
        self.tick = tick
        self._handle = None

    def __enter__(self) -> "stage":
        if not _profiling():
            return self
        import torch
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return self
        ident = _range_id(self.trace, self.tick)
        args = () if ident is None else (ident,)
        self._handle = torch.autograd._record_function_with_args_enter(
            f"raft.{self.name}", *args)
        return self

    def __exit__(self, *exc) -> bool:
        if self._handle is not None:
            import torch
            torch.autograd._record_function_with_args_exit(self._handle)
            self._handle = None
        return False


class Span:
    """One timeline interval. ``concurrent`` spans overlap tiling spans
    (background work) and never advance the trace cursor."""

    __slots__ = ("kind", "t0", "t1", "concurrent", "attrs")

    def __init__(self, kind: str, t0: float, t1: float,
                 concurrent: bool = False, attrs: Optional[Dict] = None):
        self.kind = kind
        self.t0 = t0
        self.t1 = t1
        self.concurrent = concurrent
        self.attrs = attrs or {}

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict:
        d = {"kind": self.kind, "t0": self.t0, "t1": self.t1,
             "ms": (self.t1 - self.t0) * 1e3}
        if self.concurrent:
            d["concurrent"] = True
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class RequestTrace:
    """Span timeline for one request, from admission to response.

    Mutated by whichever thread currently owns the request (submitter →
    scheduler/worker → uploader for its one concurrent span); hand-off
    happens through the service queue, which orders the accesses.
    ``finish()`` is idempotent — whoever resolves the response closes the
    trace, later calls are no-ops.
    """

    __slots__ = ("trace_id", "request_id", "t_start", "t_end", "spans",
                 "meta", "clock_pair", "_clock", "_tracer", "_cursor", "_done")

    def __init__(self, tracer: "Tracer", trace_id: str,
                 request_id, t_start: float):
        self.trace_id = trace_id
        self.request_id = request_id
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.spans: List[Span] = []
        self.meta: Dict = {}
        self.clock_pair: Optional[Dict] = None
        self._clock = tracer.clock
        self._tracer = tracer
        self._cursor = t_start
        self._done = False

    # -- recording ---------------------------------------------------------

    def mark(self, kind: str, **attrs) -> None:
        """Close the interval from the cursor to now as one tiling span
        (the phase that just ended: admission, queue_wait, ...)."""
        now = self._clock.now()
        self.spans.append(Span(kind, self._cursor, now, attrs=attrs))
        self._cursor = now

    @contextlib.contextmanager
    def span(self, kind: str, **attrs):
        """Tiling span around a code block (pad, unpad, ...), and its
        ``raft.<kind>`` profiler range (:func:`stage`)."""
        with stage(kind, self):
            t0 = self._clock.now()
            try:
                yield self
            finally:
                self.add_span(kind, t0, self._clock.now(), **attrs)

    def add_span(self, kind: str, t0: float, t1: float,
                 concurrent: bool = False, **attrs) -> None:
        """Record an explicit interval — the batched scheduler fans one
        device-call interval out to every row that rode the batch."""
        self.spans.append(Span(kind, t0, t1, concurrent=concurrent,
                               attrs=attrs))
        if not concurrent and t1 > self._cursor:
            self._cursor = t1

    def event(self, kind: str, **attrs) -> None:
        """Zero-duration decision point (breaker trip, degrade choice)."""
        now = self._clock.now()
        self.spans.append(Span(kind, now, now, concurrent=True,
                               attrs=attrs))

    def finish(self, status: str = "ok", **meta) -> None:
        if self._done:
            return
        self._done = True
        self.t_end = self._clock.now()
        self.clock_pair = _clock_pair(self._clock)
        self.meta["status"] = status
        self.meta.update({k: v for k, v in meta.items() if v is not None})
        self._tracer._record(self)

    # -- reporting ---------------------------------------------------------

    def summary(self) -> Dict:
        """Reconciliation view: total wall time vs the tiled partition."""
        t_end = self.t_end if self.t_end is not None else self._cursor
        tiled = sum(s.duration for s in self.spans if not s.concurrent)
        kinds: Dict[str, Dict] = {}
        for s in self.spans:
            k = kinds.setdefault(s.kind, {"count": 0, "ms": 0.0})
            k["count"] += 1
            k["ms"] += s.duration * 1e3
        return {"trace_id": self.trace_id,
                "total_ms": (t_end - self.t_start) * 1e3,
                "tiled_ms": tiled * 1e3,
                "kinds": kinds}

    def to_dict(self) -> Dict:
        return {"trace_id": self.trace_id,
                "request_id": self.request_id,
                "t_start": self.t_start,
                "t_end": self.t_end,
                "total_ms": ((self.t_end - self.t_start) * 1e3
                             if self.t_end is not None else None),
                "meta": dict(self.meta),
                "spans": [s.to_dict() for s in self.spans],
                "summary": self.summary(),
                "clock": self.clock_pair}


class _NullTrace:
    """Do-nothing trace: the disabled-tracing path is a handful of no-op
    method calls, no allocation, no clock reads (overhead-pinned in
    tests/test_obs.py)."""

    __slots__ = ()
    trace_id = None
    request_id = None
    spans: List[Span] = []

    def mark(self, kind: str, **attrs) -> None:
        pass

    @contextlib.contextmanager
    def span(self, kind: str, **attrs):
        with stage(kind):
            yield self

    def add_span(self, kind: str, t0: float, t1: float,
                 concurrent: bool = False, **attrs) -> None:
        pass

    def event(self, kind: str, **attrs) -> None:
        pass

    def finish(self, status: str = "ok", **meta) -> None:
        pass

    def summary(self) -> Dict:
        return {"trace_id": None, "total_ms": 0.0, "tiled_ms": 0.0,
                "kinds": {}}


NULL_TRACE = _NullTrace()


class Tracer:
    """Trace-id source + bounded recorder (ring + optional JSONL sink).

    ``sink=None`` reads ``RAFT_TRACE`` once, here (a constructor is
    function scope — GL001's import-time-read class cannot recur); pass
    ``sink=False``-y empty string to force no sink regardless of env.
    """

    def __init__(self, clock=None, ring: int = DEFAULT_RING,
                 sink: Optional[str] = None, enabled: bool = True):
        self.clock = clock if clock is not None else RealClock()
        self.enabled = enabled
        if sink is None:
            sink = os.environ.get("RAFT_TRACE") or None
        self._sink_path = sink or None
        self._sink_file = None
        self._ring: "deque[Dict]" = deque(maxlen=ring)
        self._count = 0
        self._lock = threading.Lock()
        # Sink I/O gets its OWN lock: the JSONL write happens on the
        # request-completion path, and holding the tracer-wide lock (which
        # start_request takes on every admission) across a disk write
        # would head-of-line-block admissions behind a stalled filesystem.
        self._sink_lock = threading.Lock()

    def start_request(self, request_id=None) -> RequestTrace:
        """A fresh trace (or the no-op singleton when disabled). Trace ids
        are monotonic per tracer — grep-able across the ring and sink."""
        if not self.enabled:
            return NULL_TRACE  # type: ignore[return-value]
        with self._lock:
            n = self._count
            self._count = n + 1
        return RequestTrace(self, f"req-{n:06d}", request_id,
                            self.clock.now())

    def _record(self, trace: RequestTrace) -> None:
        doc = trace.to_dict()
        with self._lock:
            self._ring.append(doc)
            sink_path = self._sink_path
        if sink_path is None:
            return
        # Telemetry must never take serving down: a sink failure (bad
        # path, disk full) runs on the request-completion path — in
        # batched mode an escaped exception would kill the scheduler
        # thread and hang every pending Future. Log once, drop the sink,
        # keep serving (the in-memory ring is unaffected).
        try:
            line = json.dumps(doc, default=str, sort_keys=True) + "\n"
            with self._sink_lock:
                if self._sink_file is None:
                    # Line-buffered append: timelines survive crashes that
                    # never reach close() (engine/logger.py's promise).
                    self._sink_file = open(sink_path, "a", buffering=1)
                self._sink_file.write(line)
        except Exception:  # noqa: BLE001 — the telemetry/serving boundary
            logger.exception(
                "trace sink %s failed — disabling the JSONL sink "
                "(in-memory ring keeps recording)", sink_path)
            with self._lock:
                self._sink_path = None
            with self._sink_lock:
                if self._sink_file is not None:
                    try:
                        self._sink_file.close()
                    except OSError:
                        pass
                    self._sink_file = None

    # -- inspection --------------------------------------------------------

    def timelines(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def last(self) -> Optional[Dict]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def status(self) -> Dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "recorded": self._count,
                    "ring": len(self._ring),
                    "sink": self._sink_path}

    def close(self) -> None:
        with self._sink_lock:
            if self._sink_file is not None:
                self._sink_file.close()
                self._sink_file = None
