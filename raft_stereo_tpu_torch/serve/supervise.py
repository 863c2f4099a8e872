"""Supervised self-healing serving (DESIGN.md "Supervision & self-healing
(r13)").

A copy of the JAX package's ``serve/supervise.py`` (host code only).

The breaker ladder (serve/guard.py) survives *kernel* failures, but
nothing supervised the threads and device calls the ladder rides on: a
hung TPU invocation parks the scheduler thread forever, a crashed tick
loop or uploader strands every pending Future, and the only shutdown
path was a cooperative ``stop()`` no signal ever triggered.  This module
adds the missing supervision layer, host-side only — no compiled program
changes, nothing here ever reaches a trace:

- :class:`InvocationWatch` — a bounded registry of in-flight device
  invocations.  ``InferenceSession.invoke`` brackets every device call
  with ``begin``/``end``; the supervisor classifies an invocation as a
  **device hang** when its age exceeds ``max(EMA x factor, floor)``
  (``floor`` = ``RAFT_WATCHDOG_MS``; warming invocations, which include
  the XLA compile, get ``floor x warm_factor`` instead — a cold TPU
  compile is minutes, not a hang);
- :class:`Heartbeat` — staleness tracking for the scheduler tick loop
  (stamped once per loop iteration) plus a crash record: the loop
  wrapper marks the heartbeat dead with the exception that killed the
  thread, so a **crashed tick loop** is detected by state, not by
  polling ``Thread.is_alive`` races;
- :class:`Supervisor` — the monitor: a daemon thread (real-time poll)
  plus a synchronous :meth:`Supervisor.check_now` that tests and the
  chaos harness drive deterministically.  Every detection is a
  :class:`WatchdogTrip` counted in
  ``raft_watchdog_trips_total{kind=}``; the response is ONE call into
  ``StereoService._bounce`` — retire the scheduler generation, re-admit
  the harvested in-flight rows from their original (still-held) inputs
  under the retry budget, and leave a flight record naming the reason.

Clock discipline: all deadline arithmetic runs on the SESSION clock
(``faults.FakeClock`` in tests — zero real sleeping in the watchdog
math); only the monitor thread's poll interval is wall time, and tests
bypass it entirely via ``check_now``.

Knobs (read here, function scope — GL001's import-time class cannot
recur; registered in ``analysis/knobs.py`` ``SERVE_ENV_KNOBS`` with the
stays-out-of-the-fingerprint rationale):

- ``RAFT_WATCHDOG_MS``   — hang-deadline floor; ``0`` (the library
  default) disarms supervision.  ``serve_stereo.py`` defaults it ON.
- ``RAFT_RETRY_BUDGET``  — bounded re-admissions per request (default 2).
- ``RAFT_DRAIN_GRACE_MS``— graceful-drain hard deadline (default 10 s).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: Steady-state hang deadline = max(EMA x FACTOR, floor): a segment that
#: takes 4x its moving estimate is stuck, not slow.
WATCHDOG_FACTOR = 4.0

#: Warming invocations include the XLA compile (minutes on TPU): their
#: hang deadline is floor x WARM_FACTOR, never the steady-state rule.
WATCHDOG_WARM_FACTOR = 120.0

#: Tick-loop staleness threshold, in floors: the loop beats once per
#: iteration (~ms), so a heartbeat this old with work pending and no
#: in-flight device call means the loop is stuck outside a device call.
STALL_FACTOR = 4.0

DEFAULT_WATCHDOG_MS = 0.0      # disarmed unless configured (env or CLI)
DEFAULT_RETRY_BUDGET = 2
DEFAULT_DRAIN_GRACE_MS = 10_000.0


def _parse_number(name: str, raw: str, cast):
    """Parse one supervision env knob's value.  A malformed value raises
    a ValueError NAMING the variable (the SLURM_CPUS_PER_TASK convention
    from data/loader.py) instead of a bare ``int()``/``float()``
    traceback that never says which env var to fix.  The ``os.environ``
    read itself stays LITERAL at each resolve_* site so GL001/GL002 can
    see it — reading through a name parameter here would blind the
    registry cross-check."""
    try:
        return cast(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be a number, got {raw!r}") from None


def resolve_watchdog_ms(value: Optional[float] = None) -> float:
    """Effective watchdog floor in ms: explicit config wins, else
    ``RAFT_WATCHDOG_MS``, else disarmed (0).  Host-side scheduling only —
    never part of any program fingerprint."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_WATCHDOG_MS", "").strip()
    if not raw:
        return DEFAULT_WATCHDOG_MS
    return _parse_number("RAFT_WATCHDOG_MS", raw, float)


def resolve_retry_budget(value: Optional[int] = None) -> int:
    """Effective per-request retry budget: explicit config wins, else
    ``RAFT_RETRY_BUDGET``, else 2."""
    if value is not None:
        return int(value)
    raw = os.environ.get("RAFT_RETRY_BUDGET", "").strip()
    if not raw:
        return DEFAULT_RETRY_BUDGET
    return _parse_number("RAFT_RETRY_BUDGET", raw, int)


def resolve_drain_grace_ms(value: Optional[float] = None) -> float:
    """Effective graceful-drain hard deadline in ms: explicit config
    wins, else ``RAFT_DRAIN_GRACE_MS``, else 10 s."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_DRAIN_GRACE_MS", "").strip()
    if not raw:
        return DEFAULT_DRAIN_GRACE_MS
    return _parse_number("RAFT_DRAIN_GRACE_MS", raw, float)


@dataclasses.dataclass(frozen=True)
class InFlight:
    """One registered device invocation (a snapshot row — the watch hands
    out copies, never its mutable state)."""

    token: int
    program: str           # ledger id of the program being invoked
    kind: str              # program kind (full/prepare/advance/...)
    warming: bool          # first invocation: compile-inclusive
    est: Optional[float]   # latency EMA for this program, if recorded
    t0: float              # session-clock start time


@dataclasses.dataclass(frozen=True)
class WatchdogTrip:
    """One watchdog detection.  ``kind`` is the metrics label
    (``raft_watchdog_trips_total{kind=}``) and selects the failure code
    budget-exhausted requests carry (``device_hang`` for hangs,
    ``scheduler_restarted`` for everything else)."""

    kind: str      # 'device_hang' | 'tick_crashed' | 'tick_stalled'
                   # | 'uploader_dead' | 'uploader_stalled'
    reason: str    # human-readable one-liner (flight records, logs)
    detail: Dict = dataclasses.field(default_factory=dict)


class InvocationWatch:
    """Bounded registry of in-flight device invocations.

    ``invoke`` calls ``begin``/``end`` around every device call; the
    supervisor reads ``active()``/``overdue()``.  All state is mutated
    under one lock — a begin/end pair costs two dict ops, nothing else
    (the disabled-supervision path pays this too; it is nanoseconds
    against a device call).
    """

    def __init__(self, clock):
        self._clock = clock
        self._lock = threading.Lock()
        self._active: Dict[int, InFlight] = {}
        self._next = 0
        self._total = 0

    def begin(self, program: str, kind: str, *, warming: bool,
              est: Optional[float]) -> int:
        with self._lock:
            token = self._next
            self._next = token + 1
            self._total += 1
            self._active[token] = InFlight(
                token=token, program=program, kind=kind, warming=warming,
                est=est, t0=self._clock.now())
        return token

    def end(self, token: int) -> None:
        with self._lock:
            self._active.pop(token, None)

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._active)

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    def active(self) -> List[InFlight]:
        with self._lock:
            return list(self._active.values())

    @staticmethod
    def allowed_s(inv: InFlight, floor_s: float,
                  factor: float = WATCHDOG_FACTOR,
                  warm_factor: float = WATCHDOG_WARM_FACTOR) -> float:
        """The hang deadline for one invocation: warming (compile-
        inclusive) gets the warm grace; steady calls get
        ``max(EMA x factor, floor)`` — EMA-less steady calls (estimate
        evicted) fall back to the floor alone."""
        if inv.warming:
            return floor_s * warm_factor
        if inv.est is None:
            return floor_s
        return max(inv.est * factor, floor_s)

    def overdue(self, now: float, floor_s: float,
                factor: float = WATCHDOG_FACTOR,
                warm_factor: float = WATCHDOG_WARM_FACTOR
                ) -> List[Tuple[InFlight, float, float]]:
        """Every in-flight invocation past its hang deadline, as
        ``(invocation, age_s, allowed_s)`` rows."""
        out = []
        for inv in self.active():
            allowed = self.allowed_s(inv, floor_s, factor, warm_factor)
            age = now - inv.t0
            if age > allowed:
                out.append((inv, age, allowed))
        return out


class Heartbeat:
    """Liveness stamp + crash record for one supervised loop thread."""

    def __init__(self, name: str, clock):
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._t_last = clock.now()
        self._died: Optional[BaseException] = None

    def beat(self) -> None:
        with self._lock:
            self._t_last = self._clock.now()

    def mark_dead(self, exc: BaseException) -> None:
        with self._lock:
            self._died = exc

    @property
    def died(self) -> Optional[BaseException]:
        with self._lock:
            return self._died

    def age(self, now: Optional[float] = None) -> float:
        if now is None:
            now = self._clock.now()
        with self._lock:
            return now - self._t_last


class Supervisor:
    """The watchdog monitor for one :class:`StereoService` generation
    lineage.

    Owns nothing but detection: every response action (bouncing the
    scheduler generation, re-admitting rows, failing budget-exhausted
    requests) goes through ``service._bounce``, so the service keeps
    single ownership of its lifecycle state.  ``check_now`` is the
    synchronous entry point tests and the chaos harness drive; the
    monitor thread merely calls it on a real-time poll.
    """

    def __init__(self, service, *, watchdog_s: float,
                 factor: float = WATCHDOG_FACTOR,
                 warm_factor: float = WATCHDOG_WARM_FACTOR,
                 stall_factor: float = STALL_FACTOR,
                 poll_s: Optional[float] = None):
        if watchdog_s <= 0:
            raise ValueError(f"Supervisor needs a positive watchdog "
                             f"floor, got {watchdog_s}")
        self._service = service
        self._session = service.session
        self._clock = self._session.clock
        self.watchdog_s = float(watchdog_s)
        self.factor = factor
        self.warm_factor = warm_factor
        self.stall_factor = stall_factor
        # Poll a quarter of the floor: a hang is detected within ~1.25
        # floors worst case, and an idle monitor costs a few wakeups/s.
        self.poll_s = (poll_s if poll_s is not None
                       else min(0.5, max(0.01, self.watchdog_s / 4)))
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # check_now is callable from the monitor thread, tests and the
        # chaos pump concurrently; one check at a time, losers skip (the
        # next poll re-checks) rather than queueing up duplicate bounces.
        self._check_lock = threading.Lock()
        # Tokens of invocations already bounced for: a REAL device hang
        # never calls watch.end(), so without this memory every sweep
        # would re-detect the same wedged invocation and bounce each
        # fresh, healthy generation in a poll-period storm.  Pruned
        # against the live set each sweep (bounded by true leaks).
        self._hang_tripped: set = set()
        reg = service.registry
        self.registry = reg
        self._m_checks = reg.counter(
            "raft_watchdog_checks_total", "supervisor sweeps run")
        self._last_check = self._clock.now()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Supervisor":
        if self._thread is None or not self._thread.is_alive():
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, name="stereo-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.poll_s):
            try:
                self.check_now()
            except Exception:  # noqa: BLE001 — the monitor must survive
                logger.exception("watchdog sweep failed; next poll retries")

    # -- detection ---------------------------------------------------------

    def check_now(self) -> List[WatchdogTrip]:
        """One synchronous watchdog sweep: detect, count, respond.
        Returns the trips found (empty = healthy).  Concurrent callers
        skip instead of stacking duplicate bounces."""
        if not self._check_lock.acquire(blocking=False):
            return []
        try:
            # _check_lock IS held here — taken by the non-blocking
            # acquire above; try/finally instead of `with` is what lets
            # concurrent sweeps skip instead of queueing (graftlock
            # models the finally-release region as held, so this needs
            # no suppression).
            return self._check_locked()
        finally:
            self._check_lock.release()

    def _check_locked(self) -> List[WatchdogTrip]:
        self._m_checks.inc()
        now = self._clock.now()
        self._last_check = now
        trips: List[WatchdogTrip] = []

        # 1. Hung device invocation: wall-clock deadline on every invoke.
        hung = self._session.watch.overdue(
            now, self.watchdog_s, self.factor, self.warm_factor)
        self._hang_tripped &= {
            inv.token for inv in self._session.watch.active()}
        for inv, age, allowed in hung:
            if inv.token in self._hang_tripped:
                continue  # already bounced for this one; a real hang
                #           never ends and must not bounce every fresh
                #           healthy generation on every sweep
            self._hang_tripped.add(inv.token)
            trips.append(WatchdogTrip(
                "device_hang",
                f"device invocation {inv.kind} ({inv.program}) in flight "
                f"{age:.3f}s > allowed {allowed:.3f}s",
                detail={"kind": inv.kind, "program": inv.program,
                        "age_s": age, "allowed_s": allowed,
                        "warming": inv.warming}))

        doc = self._service.supervised_state()
        if doc is not None:
            hb = doc["heartbeat"]
            sched = doc["scheduler"]
            thread_alive = doc["thread_alive"]

            # 2. Crashed tick loop: the loop wrapper records the killing
            # exception (state, not an is_alive race).
            died = hb.died if hb is not None else None
            if died is not None or (not thread_alive and not doc["stopping"]):
                trips.append(WatchdogTrip(
                    "tick_crashed",
                    f"scheduler tick loop died: "
                    f"{type(died).__name__ if died else 'thread exited'}"
                    f"{f': {died}' if died else ''}",
                    detail={"error": str(died) if died else None}))
            # 3. Stalled tick loop: heartbeat stale with work pending and
            # NO in-flight device call (an in-flight call is the device
            # hang's territory — double-tripping one stuck tick would
            # burn two retries for one fault).
            elif (hb is not None and sched is not None and sched.has_work
                    and not hung and self._session.watch.count == 0
                    and hb.age(now) > self.watchdog_s * self.stall_factor):
                trips.append(WatchdogTrip(
                    "tick_stalled",
                    f"scheduler heartbeat stale {hb.age(now):.3f}s with "
                    f"work pending",
                    detail={"age_s": hb.age(now)}))

            # 4. Dead or wedged uploader: its joiners' uploads can never
            # complete (a wedged one is otherwise invisible — the tick
            # loop keeps beating while run_tick finds nothing uploaded).
            uploader = sched.uploader if sched is not None else None
            if uploader is not None and not any(
                    t.kind == "tick_crashed" for t in trips):
                dead = uploader.dead
                busy = uploader.busy_since
                if dead is not None or not uploader.alive:
                    trips.append(WatchdogTrip(
                        "uploader_dead",
                        f"uploader thread dead: "
                        f"{dead if dead is not None else 'thread exited'}",
                        detail={"error": str(dead) if dead else None}))
                elif busy is not None and now - busy > \
                        self.watchdog_s * self.stall_factor:
                    trips.append(WatchdogTrip(
                        "uploader_stalled",
                        f"uploader busy {now - busy:.3f}s on one "
                        f"transfer — wedged host->device path",
                        detail={"age_s": now - busy}))

        for trip in trips:
            self.registry.counter(
                "raft_watchdog_trips_total",
                "watchdog detections by kind", kind=trip.kind).inc()
            logger.warning("watchdog trip [%s]: %s", trip.kind, trip.reason)
        if trips:
            self._service._bounce(trips)
        return trips

    # -- reporting ---------------------------------------------------------

    def status(self) -> Dict:
        return {
            "armed": self._thread is not None and self._thread.is_alive(),
            "floor_ms": self.watchdog_s * 1e3,
            "factor": self.factor,
            "warm_factor": self.warm_factor,
            "poll_ms": self.poll_s * 1e3,
            "last_check_age_s": self._clock.now() - self._last_check,
            "in_flight": [dataclasses.asdict(i)
                          for i in self._session.watch.active()],
        }


def drain_deadline(grace_s: float) -> float:
    """Wall-clock drain deadline.  Drain is an *operational* action
    (SIGTERM from an orchestrator): its hard deadline runs on real time
    even when the serving clock is fake — a FakeClock drain would
    otherwise never time out."""
    return time.monotonic() + grace_s


def drain_expired(deadline: float) -> bool:
    return time.monotonic() >= deadline
