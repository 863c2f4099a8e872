"""Deterministic fault injection for the reliability layer (DESIGN.md
"Failure recovery").

A copy of the JAX package's ``faults.py`` (numpy only), so the port imports
nothing of that package. The serving session reads its serving injectors;
the training injectors wait for the port's training slice.

Long schedules (100k+ steps, SURVEY §5) meet every failure domain
eventually: unreadable/corrupt samples, non-finite steps, truncated
checkpoints, preemption. Each recovery path in ``data/loader.py``,
``engine/train.py`` and ``engine/checkpoint.py`` is proven under test by
the injectors here. Everything is driven by an explicit :class:`FaultPlan`
value — no environment-variable side channels, no wall-clock, no global
state — so an injected fault fires at exactly the same sample/step/byte on
every run, every host, every worker-thread schedule.

The four training injectors map one-to-one onto the recovery paths:

- ``io_errors``      -> loader retry + quarantine + deterministic substitution;
- ``nan_at_steps``   -> ``optax.apply_if_finite`` skip policy + bounded abort;
- ``truncate_file``  -> checkpoint hash validation + ``find_latest_checkpoint``
  fallback to the previous good bundle;
- ``sigterm_at_step``-> ``PreemptGuard`` checkpoint-and-exit + schedule-exact
  resume.

The serving injectors (:class:`ServeFaultPlan` et al., bottom of this
module) do the same for ``raft_stereo_tpu_torch/serve/``: plan-driven compile
failures / RESOURCE_EXHAUSTED on the Nth program build, injected slow
forwards on a deterministic :class:`FakeClock` (deadline overruns),
NaN-poisoned outputs, and malformed-input generators.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
from typing import Dict, Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault schedule; all coordinates are deterministic keys.

    io_errors: dataset index -> number of injected load failures for that
        sample (``-1`` = fail every attempt, i.e. permanently corrupt).
        Counted per *attempt*, so a budget of 1 models a transient fault
        that succeeds on the loader's first retry.
    nan_at_steps: global step numbers whose batch is NaN-poisoned before
        the compiled step (exercises the skip-if-nonfinite policy).
    sigterm_at_step: deliver SIGTERM to this process at that step boundary
        (exercises the PreemptGuard checkpoint-and-exit path).
    """

    io_errors: Mapping[int, int] = dataclasses.field(default_factory=dict)
    nan_at_steps: Tuple[int, ...] = ()
    sigterm_at_step: Optional[int] = None


class FaultyDataset:
    """Dataset wrapper raising injected IO errors per :class:`FaultPlan`.

    Attempt counts are per dataset index and lock-protected: the loader's
    thread pool may probe the same quarantined index concurrently, and a
    lost increment would turn a configured-transient fault permanent.
    """

    def __init__(self, dataset, plan: FaultPlan):
        self.dataset = dataset
        self.plan = plan
        self.attempts: Dict[int, int] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index, rng=None):
        budget = self.plan.io_errors.get(int(index))
        if budget is not None:
            with self._lock:
                n = self.attempts.get(int(index), 0)
                self.attempts[int(index)] = n + 1
            if budget < 0 or n < budget:
                raise OSError(
                    f"injected IO fault for sample {index} (attempt {n + 1})")
        return self.dataset.__getitem__(index, rng=rng)


def poisoned_batches(batches: Iterable, plan: Optional[FaultPlan],
                     start_step: int = 0) -> Iterator:
    """Yield host batches, NaN-poisoning those for steps in ``nan_at_steps``.

    Applied to the *host* loader before ``device_prefetch`` so the poison
    rides the normal transfer path (including the bf16 image downcast,
    which preserves NaN). Batch ``i`` of this iterator feeds global step
    ``start_step + i`` — prefetch depth does not change that mapping, only
    when the decode happens.
    """
    for i, batch in enumerate(batches):
        if plan is not None and (start_step + i) in plan.nan_at_steps:
            batch = dict(batch)
            img = np.array(batch["image1"], copy=True)
            img[(0,) * img.ndim] = np.nan
            batch["image1"] = img
        yield batch


def fire_step_faults(plan: Optional[FaultPlan], step: int) -> None:
    """Step-boundary injections (currently: SIGTERM at a configured step)."""
    if plan is not None and plan.sigterm_at_step == step:
        os.kill(os.getpid(), signal.SIGTERM)


def truncate_file(path: str, keep_bytes: Optional[int] = None,
                  keep_frac: float = 0.5) -> int:
    """Truncate ``path`` (default: to half its size), modeling a checkpoint
    write cut off by a crash that bypassed the atomic-rename path (partial
    NFS flush, disk-full copy, ...). Returns the retained byte count."""
    size = os.path.getsize(path)
    keep = int(size * keep_frac) if keep_bytes is None else keep_bytes
    keep = max(0, min(size, keep))
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


# ---------------------------------------------------------------------------
# Serving-layer injectors (raft_stereo_tpu_torch/serve/). Same stance as the
# training injectors above: every fault is driven by an explicit plan value
# keyed on deterministic ordinals — no env vars, no randomness — so a storm
# replays identically on every run. The three injectors map onto the three
# serving recovery paths:
#
# - ``compile_errors``  -> circuit-breaker trip + fallback-ladder rebuild
#                          (serve/guard.py);
# - ``slow_forwards``   -> deadline-aware anytime degradation
#                          (serve/degrade.py best-so-far early return);
# - ``poison_outputs`` / ``malformed_pairs`` -> output validation + parity
#                          canary, and admission control (serve/validate.py).


class InjectedKernelError(RuntimeError):
    """Stands in for the compile/runtime failures a TPU fast path can
    throw (Mosaic lowering failure, XLA ``RESOURCE_EXHAUSTED``). The
    message carries the same marker substrings the circuit breaker
    classifies real failures by."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        messages = {
            "mosaic": "Mosaic lowering failed (injected)",
            "oom": "RESOURCE_EXHAUSTED: out of memory while allocating "
                   "(injected)",
        }
        msg = messages.get(kind, kind)
        if detail:
            msg = f"{msg} [{detail}]"
        super().__init__(msg)


class InjectedWorkerCrash(RuntimeError):
    """Stands in for a host-side bug that kills a serving worker thread
    (the scheduler tick loop, the uploader).  Deliberately NOT a kernel
    failure: the circuit breaker must never see it — thread death is the
    supervision layer's territory (serve/supervise.py watchdogs), not a
    fallback-ladder rung."""


@dataclasses.dataclass(frozen=True)
class ServeFaultPlan:
    """Declarative fault schedule for one :class:`~raft_stereo_tpu_torch.serve.
    session.InferenceSession`; all coordinates are deterministic ordinals.

    compile_errors: program-build ordinal (0-based count of compile
        attempts in the session, across breaker rebuilds) -> failure kind:
        ``'mosaic'`` / ``'oom'``, optionally suffixed ``':<detail>'``
        whose detail text lets the breaker's matchers attribute the
        failure to a specific fast path (e.g. ``'mosaic:gru1632'``).
    slow_builds: program-build ordinal -> real seconds to sleep inside the
        (per-bucket-locked) compile, widening the race window the compile
        locks must close.
    slow_forwards: device-invocation ordinal (0-based count of program
        executions: warmups, canary runs and request forwards all count)
        -> seconds of injected device-time, advanced on the session's
        clock (a :class:`FakeClock` makes deadline tests instantaneous
        and exact).
    poison_outputs: device-invocation ordinals whose disparity output is
        NaN-corrupted after the forward — models a silently wrong kernel;
        must be caught by output validation or the parity canary, never
        served.
    """

    compile_errors: Mapping[int, str] = dataclasses.field(default_factory=dict)
    slow_builds: Mapping[int, float] = dataclasses.field(default_factory=dict)
    slow_forwards: Mapping[int, float] = dataclasses.field(default_factory=dict)
    poison_outputs: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class ChaosPlan(ServeFaultPlan):
    """Supervision-layer chaos schedule (serve/supervise.py + the
    ``scratch/chaos_serve.py`` soak): extends :class:`ServeFaultPlan`
    with the fault classes only a watchdog can recover from.  Same
    stance as every other plan here — deterministic ordinals, no
    randomness, no env side channels — so a chaos storm replays
    identically on every run.

    hang_invokes: device-invocation ordinal (0-based count of *invoke
        entries* — a separate ordinal space from ``slow_forwards``'
        post-execution count, though the two coincide whenever every
        invoke completes) -> fake seconds the hang appears to take.  The
        invocation first advances the session clock by that many seconds
        (so a FakeClock watchdog sees it overdue immediately), then
        parks the invoking thread on a real condition until
        :meth:`ServeFaults.release_hangs` (the generation bounce calls
        it) or the ``hang_cap_s`` real-time safety cap.
    crash_uploads: upload ordinals (0-based count of rows the uploader
        thread picks up) whose processing kills the uploader thread —
        the injected form of the mid-run uploader crash that used to
        strand its joiners' Futures forever.
    crash_ticks: scheduler work-tick ordinals (0-based count of ticks
        that did work) AFTER which the tick-loop thread crashes.
    hang_chips: mesh chip ordinals whose post-bounce health probe
        (``InferenceSession.probe_chips`` -> ``on_chip_probe``) parks —
        the injected form of ONE chip of a data mesh staying wedged
        while its siblings answer, so the chip-local quarantine path is
        CPU-testable.  Parked probes ride the same release
        epoch/real-time cap as ``hang_invokes``.
    hang_cap_s: real-seconds safety cap on any injected hang, so a test
        that never bounces cannot deadlock the suite.
    clear_after_invokes: graftheal (r22) transient-fault window — the
        plan's HANG faults (``hang_invokes`` parks and ``hang_chips``
        probe parks) stop firing once this many device invocations have
        entered since the plan was installed on its
        :class:`ServeFaults`.  Models a fault that clears under load;
        the ordinal-keyed faults (``compile_errors``, ``slow_forwards``,
        ``poison_outputs``) are already self-limiting by ordinal and are
        NOT gated, so existing storm ordinals stay byte-stable.
    clear_after_ms: same window on the injectable session clock: hang
        faults stop firing once the clock has advanced this many ms past
        plan installation.  Either bound clearing the window clears it.
    """

    hang_invokes: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    crash_uploads: Tuple[int, ...] = ()
    crash_ticks: Tuple[int, ...] = ()
    hang_chips: Tuple[int, ...] = ()
    hang_cap_s: float = 30.0
    clear_after_invokes: Optional[int] = None
    clear_after_ms: Optional[float] = None


class ServeFaults:
    """Lock-protected ordinal counters binding a :class:`ServeFaultPlan`
    to one session (mirrors :class:`FaultyDataset` for the loader)."""

    def __init__(self, plan: Optional[ServeFaultPlan], clock=None):
        self.clock = clock
        self.builds = 0
        self.forwards = 0
        self.invokes = 0
        self.uploads = 0
        self.ticks = 0
        self._lock = threading.Lock()
        # Injected hangs park on this condition until release_hangs()
        # (the watchdog bounce) bumps the epoch, or the plan's real-time
        # cap expires.  ``hangs_entered`` lets tests wait until the
        # victim thread is provably parked before advancing the clock.
        self._hang_cv = threading.Condition()
        self.hangs_entered = 0
        self._hang_epoch = 0
        # graftheal transient-fault windows are measured from plan
        # INSTALLATION (the property setter below re-bases them), so a
        # test that swaps plans mid-run gets a fresh window — assigned
        # last: the setter reads the counters above.
        self._window_invokes0 = 0
        self._window_t0: Optional[float] = None
        self.plan = plan

    @property
    def plan(self) -> Optional[ServeFaultPlan]:
        return self._plan

    @plan.setter
    def plan(self, plan: Optional[ServeFaultPlan]) -> None:
        # Plans stay reassignable mid-run (storms swap them); each
        # install re-bases the transient window's invoke/clock origin.
        with self._lock:
            self._plan = plan
            self._window_invokes0 = self.invokes
            self._window_t0 = (self.clock.now()
                               if self.clock is not None else None)

    def _cleared(self, ordinal: Optional[int] = None) -> bool:
        """True when the plan's transient-fault window has expired —
        hang faults (invoke parks, chip-probe parks) stop firing.  The
        ordinal counters themselves are NEVER gated: deterministic fault
        ordinals survive the window."""
        plan = self._plan
        n_clear = getattr(plan, "clear_after_invokes", None)
        if n_clear is not None:
            with self._lock:
                count = (ordinal if ordinal is not None
                         else self.invokes) - self._window_invokes0
            if count >= n_clear:
                return True
        ms_clear = getattr(plan, "clear_after_ms", None)
        if ms_clear is not None and self.clock is not None \
                and self._window_t0 is not None:
            if self.clock.now() - self._window_t0 >= ms_clear / 1e3:
                return True
        return False

    def on_build(self) -> int:
        """Fire at each program-compile attempt; raises the injected
        compile failure for this ordinal, if any."""
        with self._lock:
            n = self.builds
            self.builds = n + 1
        if self.plan is None:
            return n
        slow = self.plan.slow_builds.get(n)
        if slow:
            import time
            time.sleep(slow)
        kind = self.plan.compile_errors.get(n)
        if kind is not None:
            base, _, detail = kind.partition(":")
            raise InjectedKernelError(base, detail)
        return n

    def on_forward(self) -> int:
        """Fire after each device-program invocation; advances the
        session clock by any injected slowness. Returns the ordinal so
        the caller can apply ``poisoned()``."""
        with self._lock:
            n = self.forwards
            self.forwards = n + 1
        if self.plan is not None:
            slow = self.plan.slow_forwards.get(n)
            if slow and self.clock is not None:
                self.clock.sleep(slow)
        return n

    def poisoned(self, ordinal: int) -> bool:
        return self.plan is not None and ordinal in self.plan.poison_outputs

    # -- supervision-layer injectors (ChaosPlan; plain ServeFaultPlans
    # have none of these fields, so every hook is a counted no-op) ------

    def on_invoke(self) -> int:
        """Fire at each device-invocation ENTRY (before the program
        runs, inside the session's invocation watch window); parks the
        calling thread on an injected hang for this ordinal, if any."""
        with self._lock:
            n = self.invokes
            self.invokes = n + 1
        hang = getattr(self.plan, "hang_invokes", None)
        if not hang or n not in hang or self._cleared(ordinal=n):
            return n
        # Capture the release epoch BEFORE the clock advance below: the
        # advance is what makes this hang detectable, so a supervisor
        # sweep (and its release_hangs) can land in the gap between the
        # sleep and the park — an epoch read after that release would
        # miss it and park the victim for the full real-time cap.
        with self._hang_cv:
            epoch = self._hang_epoch
        # The hang's apparent duration lands on the session clock FIRST:
        # a FakeClock watchdog sees the invocation overdue the moment the
        # victim parks, with zero real sleeping in the deadline math.
        if self.clock is not None and hang[n]:
            self.clock.sleep(hang[n])
        import time
        cap = time.monotonic() + getattr(self.plan, "hang_cap_s", 30.0)
        with self._hang_cv:
            self.hangs_entered += 1
            self._hang_cv.notify_all()
            while self._hang_epoch == epoch and time.monotonic() < cap:
                self._hang_cv.wait(0.05)
        return n

    def on_chip_probe(self, chip: int) -> None:
        """Fire inside each mesh chip-health probe thread
        (``InferenceSession.probe_chips``); parks the probe for a chip in
        the plan's ``hang_chips`` — modeling a chip that stays wedged
        after the bounce freed the invoke-level hang.  Parked probes use
        the SAME epoch condition as ``on_invoke`` hangs, so they respect
        ``release_hangs`` and the real-time cap; a probe that parks past
        its caller's join timeout reads as a hung chip, which is the
        point."""
        if chip not in getattr(self.plan, "hang_chips", ()) \
                or self._cleared():
            return
        with self._hang_cv:
            epoch = self._hang_epoch
        import time
        cap = time.monotonic() + getattr(self.plan, "hang_cap_s", 30.0)
        with self._hang_cv:
            self.hangs_entered += 1
            self._hang_cv.notify_all()
            while self._hang_epoch == epoch and time.monotonic() < cap:
                self._hang_cv.wait(0.05)

    def release_hangs(self) -> None:
        """Unpark every currently-hung invocation (the generation bounce
        calls this so an abandoned victim thread can run to its no-op
        completion instead of leaking until the real-time cap)."""
        with self._hang_cv:
            self._hang_epoch += 1
            self._hang_cv.notify_all()

    def wait_hang_entered(self, n: int = 1, timeout: float = 30.0) -> bool:
        """Block (real time) until at least ``n`` injected hangs have
        parked their victims — the test-side rendezvous."""
        import time
        deadline = time.monotonic() + timeout
        with self._hang_cv:
            while self.hangs_entered < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._hang_cv.wait(min(0.05, remaining))
        return True

    def on_upload(self) -> int:
        """Fire as the uploader thread picks up each row; raises the
        injected thread-killing crash for this ordinal, if any."""
        with self._lock:
            n = self.uploads
            self.uploads = n + 1
        if n in getattr(self.plan, "crash_uploads", ()):
            raise InjectedWorkerCrash(
                f"injected uploader crash at upload {n}")
        return n

    def on_tick(self) -> int:
        """Fire after each scheduler work-tick; raises the injected
        tick-loop crash for this ordinal, if any."""
        with self._lock:
            n = self.ticks
            self.ticks = n + 1
        if n in getattr(self.plan, "crash_ticks", ()):
            raise InjectedWorkerCrash(
                f"injected tick-loop crash after work tick {n}")
        return n


# ---------------------------------------------------------------------------
# Wire-level injectors (graftwire, serve/http.py + scratch/chaos_serve.py
# --wire). Unlike every plan above, these describe CLIENT behavior: the
# hostile things a network peer does to an ingress — truncating an upload,
# stalling a socket at a chosen byte, flooding headers, disconnecting
# mid-request, sending garbage or a decompression bomb. The storm harness
# plays them over real loopback sockets; the server side is entirely
# unmodified production code, which is the point.


#: Every hostile client behavior the wire storm can inject, with the
#: structured code (or connection outcome) the ingress must answer.
WIRE_FAULT_KINDS: Tuple[str, ...] = (
    "ok",                        # well-formed request -> 200
    "truncated_body",            # short body + half-close -> 400
    "stalled_body",              # stop sending mid-body -> 408
    "garbage_image",             # undecodable part bytes -> 400
    "bomb_image",                # crafted huge-header PNG -> 413
    "header_flood",              # >100 headers -> 431
    "disconnect_mid_request",    # close without reading the response
    "oversize_content_length",   # declared length > cap -> 413
    "empty_body",                # Content-Length: 0 -> 400
    "bad_multipart",             # boundary-less multipart -> 400
    "wrong_route",               # POST /v1/nope -> 404
    "bad_method",                # DELETE /v1/stereo -> 405
)


@dataclasses.dataclass(frozen=True)
class WireChaosPlan:
    """Deterministic client-side fault schedule for the network storm.

    faults: request ordinal -> fault kind (one of
        :data:`WIRE_FAULT_KINDS`); ordinals absent from the map are
        well-formed requests. Same stance as every plan here: explicit
        values keyed on deterministic ordinals, so a storm replays
        identically on every run.
    truncate_frac / stall_frac: the deterministic BYTE ordinal (as a
        fraction of the encoded body) at which a truncating client stops
        sending / a stalling client goes silent.
    stall_hold_s: how long a stalled client keeps its socket open
        waiting for the server's verdict (must exceed the ingress
        per-read timeout for the fault to be non-vacuous).
    flood_headers: header count for the flood fault (the stdlib parser
        rejects past 100).
    """

    faults: Mapping[int, str] = dataclasses.field(default_factory=dict)
    truncate_frac: float = 0.5
    stall_frac: float = 0.25
    stall_hold_s: float = 5.0
    flood_headers: int = 150

    @staticmethod
    def seeded(seed: int, n: int, hostile_frac: float = 0.5,
               kinds: Optional[Tuple[str, ...]] = None) -> "WireChaosPlan":
        """A reproducible storm: ``hostile_frac`` of ``n`` ordinals get a
        fault kind drawn round-robin-shuffled from ``kinds`` (default:
        every kind except ``ok``), the rest stay well-formed."""
        kinds = tuple(kinds if kinds is not None else
                      [k for k in WIRE_FAULT_KINDS if k != "ok"])
        rng = np.random.default_rng(seed)
        n_hostile = int(n * hostile_frac)
        ordinals = rng.choice(n, size=n_hostile, replace=False)
        # Every kind appears before any repeats (shuffled blocks), so a
        # small storm still exercises the full fault surface.
        assignment = []
        while len(assignment) < n_hostile:
            block = list(kinds)
            rng.shuffle(block)
            assignment.extend(block)
        faults = {int(o): assignment[i]
                  for i, o in enumerate(sorted(int(x) for x in ordinals))}
        return WireChaosPlan(faults=faults)


def bomb_png(width: int, height: int) -> bytes:
    """A syntactically valid PNG whose IHDR declares ``width x height``
    pixels backed by almost no data — the crafted decompression bomb the
    ingress guard must reject from the HEADER alone (a real decode of a
    100 MP declaration would allocate ~300 MB from these few hundred
    bytes)."""
    import struct
    import zlib

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    idat = zlib.compress(b"\x00")
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def poison_disparity(arr: np.ndarray) -> np.ndarray:
    """NaN-corrupt a disparity field (injected silently-wrong kernel).
    Poisons the CENTER pixel — corner pixels sit in the bucket padding and
    would be sliced away before output validation ever saw them."""
    out = np.array(arr, copy=True)
    out[tuple(s // 2 for s in out.shape)] = np.nan
    return out


class FakeClock:
    """Deterministic clock for deadline tests: ``now()`` advances only via
    ``sleep()``, so an injected 10-second overrun costs zero wall time and
    deadline arithmetic is exact on any machine. The serving layer takes
    any object with this interface; production uses :class:`RealClock`."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self._now += float(seconds)


class RealClock:
    """Monotonic wall clock (the serving default)."""

    @staticmethod
    def now() -> float:
        import time
        return time.monotonic()

    @staticmethod
    def sleep(seconds: float) -> None:
        import time
        time.sleep(seconds)


def malformed_pairs(h: int = 48, w: int = 64,
                    oversize_pixels: Optional[int] = None) -> Dict[str, Tuple]:
    """Generators for the admission-control test battery: each entry is a
    ``name -> (left, right)`` pair that a serving session must REJECT with
    a structured error (never crash on, never silently serve).

    ``oversize_pixels``: admission limit to exceed for the ``oversized``
    case (omitted when None — building a >limit array may be expensive)."""
    rng = np.random.default_rng(7)

    def img(hh=h, ww=w, c=3):
        return rng.uniform(0, 255, size=(hh, ww, c)).astype(np.float32)

    good = img()
    nan_img = img()
    nan_img[0, 0, 0] = np.nan
    inf_img = img()
    inf_img[-1, -1, -1] = np.inf
    pairs: Dict[str, Tuple] = {
        "nan_pixels": (nan_img, img()),
        "inf_pixels": (good, inf_img),
        "five_channel": (img(c=5), img(c=5)),
        "zero_area": (img(hh=0), img(hh=0)),
        "mismatched_shapes": (img(), img(ww=w + 4)),
        "wrong_rank": (rng.uniform(0, 255, size=(h, w)).astype(np.float32),) * 2,
        "not_an_array": ([[1.0, 2.0], [3.0, 4.0]], good),
    }
    if oversize_pixels is not None:
        side = int(np.ceil(np.sqrt(oversize_pixels))) + 1
        pairs["oversized"] = (img(hh=side, ww=side), img(hh=side, ww=side))
    return pairs
