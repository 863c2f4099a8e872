"""Kernel circuit breaker: trip a fast path, fall back, keep serving.

The port's counterpart of the JAX package's ``serve/guard.py``. The forward
runs hand-written CUDA kernels behind switches (``config.py``): the resident
iteration kernel, gru16+32, the int8 correlation and context lanes, the
encoder kernels and their stream tail, and the kernel-backed correlations.
This module declares each switch once as a rung of a **fallback ladder**. On
a classified kernel failure the breaker trips one rung, the session rebuilds
its programs one step down and serves the request again, and the trip is
logged, counted and listed in the session's status. The process degrades; it
does not die.

The port's ladder keeps the JAX ladder's rungs whose switch the port has, in
the JAX order. It drops two:

- ``stream_batch``: the JAX rung sends B > 1 loop calls to XLA, a TPU
  policy (``RAFT_STREAM_BATCH``). The port's loop kernels engage at every
  batch (the encoder kernels at B=1, and a batched serving ``prepare``
  runs row by row, ``serve/session.py``), and the rung's fallback would be
  plain PyTorch, which the card's ``kernels_only`` breaker never serves;
- ``packed_l2``: a TPU bit layout the port never had.

The bottom rung, ``fused_update`` (``RAFTStereoConfig.fused_update``), turns
the refinement loop's kernels off: the serial ConvGRU and motion kernels
(``conv_gru.cu``, ``motion.cu``), the fallback of ``fuse_iter`` and
``fuse_gru1632``. With every rung tripped a program launches no hand-written
kernel, as the JAX package's last ladder program does.

``corr_kernel`` maps ``reg_cuda`` to ``reg`` and ``alt_cuda`` to ``alt``,
plain torch correlations, as the JAX package's XLA twins are.

Four rungs fall back to plain PyTorch (``plain_route``): ``stream_tail`` and
``fused_encoders`` to cuDNN convolutions and torch norms, ``corr_kernel`` to
torch correlation, ``fused_update`` to the torch loop. The session on the card builds its breaker with
``kernels_only``: it never trips those rungs, so a served frame never leaves
the hand-written kernels. A failure whose rung is one of them (a launch or
build failure attributed to it, or an OOM or canary mismatch that reaches it
in ladder order) ends the request in a structured error instead. The rungs
it keeps (``fuse_iter``, ``lane_pack8``, ``corr_pack8``, ``fuse_gru1632``)
fall back to other hand-written kernels: the serial loop kernels, bf16
levels and lanes, the head-less GRU steps.

Two failures are never walked down the ladder (:func:`fatal_code`): a sticky
CUDA error (an illegal address, a launch failure), after which the context
is unusable, and a failure while a program is being captured into a CUDA
graph. Both end the request in a structured error.

Trips are one-way while the recovery plane is off (``RAFT_HEAL=0``). With
healing armed, a tripped rung enters probation: after a backoff on the
session clock the session's heal sweep runs the parity canary with the rung
back on, and re-engages it only if the canary passes.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, Mapping, Optional, Tuple, Union

from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
from raft_stereo_tpu_torch.faults import InjectedKernelError

logger = logging.getLogger(__name__)

# Parity canary drift band, the JAX package's: per pixel, relative 5e-3 and
# an absolute floor of 0.05 px, below any metric threshold (the tightest
# evaluation threshold is D1 at 1 px).
CANARY_RTOL = 5e-3
CANARY_ATOL = 5e-2


@dataclasses.dataclass(frozen=True)
class FastPath:
    """One fast path: its switch and its fallback.

    env_var/env_off: the environment switch; tripping exports
        ``env_var=env_off`` for every later program.
    cfg_field/cfg_fallback: a config-field switch; tripping rewrites the
        session's run config. A dict maps the current value to its
        fallback (``reg_cuda -> reg``); a plain value replaces outright.
    matchers: lowercase substrings that attribute a failure message to this
        path. The port's kernels fail as ``CUDA kernel <name> failed to
        launch`` (``kernels.check``), so the names are the kernels' own.
    plain_route: the fallback leaves the hand-written kernels for plain
        PyTorch; a ``kernels_only`` breaker never trips this rung.
    """

    name: str
    description: str
    env_var: Optional[str] = None
    env_off: str = "0"
    cfg_field: Optional[str] = None
    cfg_fallback: Union[None, bool, Mapping[str, str]] = None
    matchers: Tuple[str, ...] = ()
    plain_route: bool = False


# Ladder order: the cheapest loss first, the JAX package's order.
DEFAULT_LADDER: Tuple[FastPath, ...] = (
    FastPath(
        name="fuse_iter",
        description="resident iteration kernel: lookup + motion encoder + "
                    "gru08 + flow head in one launch (csrc/resident.cu)",
        env_var="RAFT_FUSE_ITER",
        matchers=("fuse_iter", "kernel resident"),
    ),
    FastPath(
        # Before corr_pack8: classify() walks the ladder in order and
        # "pack8" is a substring of every "lane_pack8" message.
        name="lane_pack8",
        description="int8 context lanes and feature maps in the carry "
                    "(RAFT_LANE_PACK8)",
        env_var="RAFT_LANE_PACK8",
        matchers=("lane_pack8", "lane8", "czrq"),
    ),
    FastPath(
        name="corr_pack8",
        description="int8 correlation levels (corr/reg_cuda.py "
                    "RAFT_CORR_PACK8)",
        env_var="RAFT_CORR_PACK8",
        matchers=("pack8",),
    ),
    FastPath(
        name="fuse_gru1632",
        description="gru32 and gru16 in one launch (csrc/gru1632.cu)",
        env_var="RAFT_FUSE_GRU1632",
        matchers=("gru1632",),
    ),
    FastPath(
        name="stream_tail",
        description="the encoders' stride-1 tail blocks and finest heads "
                    "through the encoder kernels (RAFT_STREAM_TAIL)",
        env_var="RAFT_STREAM_TAIL",
        matchers=("stream_tail",),
        plain_route=True,
    ),
    FastPath(
        name="corr_kernel",
        description="CUDA correlation lookup / alt kernel -> plain torch "
                    "correlation (csrc/corr_lookup.cu, csrc/corr_alt.cu)",
        cfg_field="corr_implementation",
        cfg_fallback={"reg_cuda": "reg", "alt_cuda": "alt",
                      "reg_tpu": "reg", "alt_tpu": "alt"},
        matchers=("corr_lookup", "corr_alt", "corr_kernel"),
        plain_route=True,
    ),
    FastPath(
        name="fused_encoders",
        description="the encoder kernels: stem, 3x3 pass, point exits "
                    "(csrc/enc_stem.cu, enc_pass.cu, enc_point.cu)",
        env_var="RAFT_FUSED_ENCODERS",
        matchers=("enc_stem", "enc_pass", "enc_point", "fused_encoders"),
        plain_route=True,
    ),
    FastPath(
        # Last: classify() reaches it only after every other rung. The
        # serial kernels fail as "CUDA kernel conv_gru ..." / "CUDA kernel
        # motion ...", which no earlier rung's matchers name.
        name="fused_update",
        description="the refinement loop's kernels: serial ConvGRU and "
                    "motion encoder (csrc/conv_gru.cu, motion.cu) -> the "
                    "torch loop (cfg.fused_update)",
        cfg_field="fused_update",
        cfg_fallback=False,
        matchers=("kernel conv_gru", "kernel motion", "fused_update"),
        plain_route=True,
    ),
)


@dataclasses.dataclass(frozen=True)
class FailureMarker:
    """One failure-classifier marker: a lowercase substring whose presence
    in ``str(exc).lower()`` marks the exception as a kernel failure
    (breaker territory), the category it attributes, and why it is specific
    enough to trust."""

    substring: str
    category: str  # 'oom' | 'kernel_build' | 'kernel_launch' | 'cuda_library'
    note: str


# The one table of kernel-failure markers. An exception is a kernel failure
# only if it is an injected kernel error, a CUDA out-of-memory error by type
# name, or its message carries one of these substrings. Anything else (a
# TypeError in our own code, a KeyboardInterrupt) must propagate: a marker
# loose enough to match an application error would turn crashes into
# silent rung walks.
KERNEL_FAILURE_MARKERS: Tuple[FailureMarker, ...] = (
    FailureMarker("out of memory", "oom",
                  "the CUDA caching allocator's OOM message"),
    FailureMarker("resource_exhausted", "oom",
                  "the injected OOM's text (faults.InjectedKernelError)"),
    FailureMarker("failed to launch", "kernel_launch",
                  "kernels.check: a hand-written kernel's launch returned a "
                  "cudaError_t"),
    FailureMarker("kernel build failed", "kernel_build",
                  "kernels.build: nvcc refused a source"),
    FailureMarker("nvcc not found", "kernel_build",
                  "kernels.nvcc_path: no CUDA toolkit to build with"),
    FailureMarker("cudnn_status", "cuda_library",
                  "a cuDNN status in a plain convolution"),
    FailureMarker("cublas_status", "cuda_library",
                  "a cuBLAS status in a plain matrix product"),
)

#: Exception type names that are kernel failures whatever their message.
KERNEL_FAILURE_TYPE_NAMES = ("OutOfMemoryError",)

# Sticky CUDA errors: after one the context is unusable, so the session
# neither retries nor walks the ladder. The texts are the CUDA runtime's
# error strings as torch reports them (whole enough not to match the hint
# torch appends to every CUDA error, "... to enable device-side
# assertions."), and the cudaError_t numbers that
# ``kernels.check`` reports (700 illegal address, 710 device assert, 714
# hardware stack, 715 illegal instruction, 716 misaligned address, 717
# invalid address space, 718 invalid pc, 719 launch failure).
STICKY_CUDA_MARKERS: Tuple[str, ...] = (
    "illegal memory access", "unspecified launch failure",
    "illegal instruction", "misaligned address", "device-side assert triggered",
    "hardware stack error", "invalid program counter",
    *(f"cudaerror_t {code}" for code in range(714, 720)),
    "cudaerror_t 700", "cudaerror_t 710",
)

#: ``_raft_phase`` of an exception raised while a program was being
#: captured into a CUDA graph.
CAPTURE_PHASE = "capture_failure"


def match_failure_marker(exc: BaseException) -> Optional[FailureMarker]:
    """The first marker whose substring appears in the exception message,
    else None."""
    msg = str(exc).lower()
    for marker in KERNEL_FAILURE_MARKERS:
        if marker.substring in msg:
            return marker
    return None


def is_kernel_failure(exc: BaseException) -> bool:
    if isinstance(exc, InjectedKernelError):
        return True
    if type(exc).__name__ in KERNEL_FAILURE_TYPE_NAMES:
        return True
    return match_failure_marker(exc) is not None


def fatal_code(exc: BaseException) -> Optional[str]:
    """``'cuda_sticky_error'`` for a sticky CUDA error, ``'capture_failed'``
    for a failure while capturing a program, else None. Either one ends the
    request in a structured error with no retry and no trip."""
    msg = str(exc).lower()
    if any(m in msg for m in STICKY_CUDA_MARKERS):
        return "cuda_sticky_error"
    if getattr(exc, "_raft_phase", None) == CAPTURE_PHASE:
        return "capture_failed"
    return None


@dataclasses.dataclass
class TripRecord:
    path: str
    reason: str          # 'compile_failure' | 'runtime_failure' |
                         # 'canary_mismatch' | 'manual'
    error: str = ""
    count: int = 1
    at: float = dataclasses.field(default_factory=time.time)


class LadderExhausted(RuntimeError):
    """Every rung is tripped and the bottom-rung program still failed."""


class KernelCircuitBreaker:
    """Trip registry + fallback ladder for one serving process.

    Thread-safe; shared between an :class:`~raft_stereo_tpu_torch.serve.session.
    InferenceSession` and its service wrapper so /healthz sees trips the
    moment they happen.

    ``kernels_only`` (the card's session): the rungs whose fallback is plain
    PyTorch (``FastPath.plain_route``) are never tripped; the session ends a
    failure that classifies to one of them in a structured error.
    """

    def __init__(self, ladder: Tuple[FastPath, ...] = DEFAULT_LADDER,
                 registry=None, *, kernels_only: bool = False):
        # obs/metrics.py registry (optional): when bound, every trip also
        # increments raft_breaker_trips_total{rung,reason} so /metrics
        # carries the ladder walk without a second bookkeeping path.
        self._registry = registry
        self.ladder = tuple(ladder)
        self.kernels_only = bool(kernels_only)
        self._by_name = {p.name: p for p in self.ladder}
        if len(self._by_name) != len(self.ladder):
            raise ValueError("duplicate fast-path names in ladder")
        # Fingerprint/trace contract (one registry: analysis/knobs.py): a
        # rung's env switch must be in ENV_KNOBS so UNTRIPPED programs key
        # on it too. resolve_env keeps unknown override keys — the trace
        # still sees the switch — so drift is a warning, not an error
        # (tests inject synthetic ladders).
        for p in self.ladder:
            if p.env_var is not None and p.env_var not in ENV_KNOBS:
                logger.warning(
                    "ladder rung %s uses env var %s not in ENV_KNOBS "
                    "(raft_stereo_tpu_torch/analysis/knobs.py) — add it so "
                    "untripped programs key on it too", p.name, p.env_var)
        self._tripped: Dict[str, TripRecord] = {}
        self._lock = threading.Lock()
        # graftheal (r22) probation state. Disarmed until the owning
        # session calls configure_heal with its clock — an unconfigured
        # breaker keeps the historical one-way semantics bit-for-bit.
        self._heal_enabled = False
        self._heal_clock = None
        self._heal_backoff_s = 30.0
        self._heal_backoff_max_s = 480.0
        # rung -> {backoff_s, deadline, probes, retrips}; deadlines run
        # on the session clock (FakeClock in tests/storms).
        self._probation: Dict[str, Dict] = {}

    def bind_registry(self, registry) -> None:
        """Attach a metrics registry (first bind wins — a breaker shared
        between sessions keeps reporting into the store it started
        with)."""
        if self._registry is None:
            self._registry = registry

    def configure_heal(self, *, enabled: bool, clock,
                       backoff_s: float, backoff_max_s: float) -> None:
        """Arm (or disarm) half-open probation for this breaker.  Called
        by the owning session with ITS clock so every probation deadline
        rides the same FakeClock the tests/storms drive.  Existing trips
        (a breaker shared across a rebuild) are put on probation at one
        full backoff from now — never instantly eligible."""
        with self._lock:
            self._heal_enabled = bool(enabled)
            self._heal_clock = clock
            self._heal_backoff_s = float(backoff_s)
            self._heal_backoff_max_s = float(backoff_max_s)
            if not self._heal_enabled or clock is None:
                self._probation.clear()
                return
            now = clock.now()
            for name in self._tripped:
                if name not in self._probation:
                    self._probation[name] = {
                        "backoff_s": self._heal_backoff_s,
                        "deadline": now + self._heal_backoff_s,
                        "probes": 0, "retrips": 0}

    # -- state ------------------------------------------------------------

    @property
    def tripped_names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._tripped)

    @property
    def trip_count(self) -> int:
        with self._lock:
            return sum(r.count for r in self._tripped.values())

    @property
    def exhausted(self) -> bool:
        """True when the session is at the bottom rung (no rung left that
        this breaker may trip)."""
        with self._lock:
            return self._at_bottom()

    def _at_bottom(self) -> bool:
        """Called under ``_lock``."""
        return not any(p.name not in self._tripped and not self.refuses(p)
                       for p in self.ladder)

    def refuses(self, path: FastPath) -> bool:
        """Whether this breaker never trips ``path``: a ``kernels_only``
        breaker keeps the session off the plain routes."""
        return self.kernels_only and path.plain_route

    def fingerprint(self) -> Tuple[str, ...]:
        """Stable component of compile-cache keys: programs traced under a
        different trip set must never be served for this one."""
        with self._lock:
            return tuple(sorted(self._tripped))

    # -- classification ---------------------------------------------------

    def classify(self, exc: BaseException) -> Optional[FastPath]:
        """The rung to trip for this failure: the first *untripped* path
        whose matchers hit the message, else the first untripped path in
        ladder order (a generic OOM/compile failure walks the ladder top
        down), else None — the ladder is exhausted."""
        msg = str(exc).lower()
        with self._lock:
            untripped = [p for p in self.ladder if p.name not in self._tripped]
        for p in untripped:
            if any(m in msg for m in p.matchers):
                return p
        return untripped[0] if untripped else None

    # -- transitions ------------------------------------------------------

    def trip(self, name: str, reason: str,
             error: Optional[BaseException] = None) -> TripRecord:
        if name not in self._by_name:
            raise KeyError(f"unknown fast path {name!r}")
        if self.refuses(self._by_name[name]):
            raise ValueError(f"rung {name} falls back to plain PyTorch; a kernels_only "
                             "breaker never trips it")
        if self._registry is not None:
            self._registry.counter(
                "raft_breaker_trips_total",
                "circuit-breaker trips by rung and reason",
                rung=name, reason=reason).inc()
        with self._lock:
            rec = self._tripped.get(name)
            if rec is None:
                rec = TripRecord(path=name, reason=reason,
                                 error=str(error) if error else "")
                self._tripped[name] = rec
            else:  # repeated failure attributed to an already-dark path
                rec.count += 1
            if self._heal_enabled and self._heal_clock is not None:
                now = self._heal_clock.now()
                st = self._probation.get(name)
                if st is None:
                    # First trip of this rung: probation at base backoff.
                    self._probation[name] = {
                        "backoff_s": self._heal_backoff_s,
                        "deadline": now + self._heal_backoff_s,
                        "probes": 0, "retrips": 0}
                else:
                    # Re-trip (incl. a failed half-open canary): backoff
                    # doubles, capped — a persistently broken kernel
                    # settles at one canary per max-backoff period.
                    st["backoff_s"] = min(st["backoff_s"] * 2.0,
                                          self._heal_backoff_max_s)
                    st["deadline"] = now + st["backoff_s"]
                    st["retrips"] += 1
            return rec

    # -- half-open probation (graftheal r22) -------------------------------

    def heal_candidate(self, now: Optional[float] = None) -> Optional[str]:
        """The ONE rung eligible for a half-open canary probe right now,
        or None.  Only the MOST recently tripped rung is ever a
        candidate (``_tripped`` is insertion-ordered, so re-engagement
        walks the ladder back in strict reverse trip order — re-arming a
        lower rung under a still-dark higher one would canary a
        configuration that was never served).  Handing out a candidate
        pushes its deadline one backoff out, so a sweep that dies
        mid-probe cannot hand the same rung to a concurrent sweep."""
        with self._lock:
            if not self._heal_enabled or self._heal_clock is None \
                    or not self._tripped:
                return None
            if now is None:
                now = self._heal_clock.now()
            name = next(reversed(self._tripped))
            st = self._probation.get(name)
            if st is None:  # tripped before heal was configured
                self._probation[name] = {
                    "backoff_s": self._heal_backoff_s,
                    "deadline": now + self._heal_backoff_s,
                    "probes": 0, "retrips": 0}
                return None
            if now < st["deadline"]:
                return None
            st["probes"] += 1
            st["deadline"] = now + st["backoff_s"]
            return name

    def untrip(self, name: str) -> bool:
        """Half-open canary passed: the rung re-engages.  Removes the
        trip record AND its probation state (a later re-trip starts back
        at the base backoff — the fault class that cleared is not the
        one that re-trips).  The caller owns re-keying: the trip set is
        in the program-cache projection, so it must rebuild its run
        config and RE-WARM before routing traffic (or a request would
        pay a build mid-flight)."""
        with self._lock:
            if name not in self._tripped:
                return False
            del self._tripped[name]
            self._probation.pop(name, None)
        if self._registry is not None:
            self._registry.counter(
                "raft_heal_untrips_total",
                "breaker rungs re-engaged after a passing half-open "
                "canary", rung=name).inc()
        return True

    def heal_status(self) -> Dict:
        """The /healthz ``breaker.heal`` block: probation state per
        still-tripped rung."""
        with self._lock:
            now = (self._heal_clock.now()
                   if self._heal_clock is not None else None)
            half_open = {}
            for name, st in self._probation.items():
                row = {"backoff_ms": st["backoff_s"] * 1e3,
                       "probes": st["probes"],
                       "retrips": st["retrips"]}
                if now is not None:
                    row["eligible_in_s"] = max(0.0, st["deadline"] - now)
                half_open[name] = row
            return {"enabled": self._heal_enabled,
                    "half_open": half_open}

    def reset(self) -> None:
        """Operator action: forget all trips (e.g. after a kernel fix)."""
        with self._lock:
            self._tripped.clear()
            self._probation.clear()

    # -- application ------------------------------------------------------

    def apply(self, cfg, tripped: Optional[Tuple[str, ...]] = None):
        """Project a trip set (default: the current one) onto a run config
        + env overrides.

        Returns ``(run_cfg, env)`` where ``run_cfg`` is ``cfg`` with every
        tripped config-field switch rewritten and ``env`` maps each
        tripped env-var switch to its off value — to be exported around
        every trace of a serving program.
        """
        overrides = {}
        env: Dict[str, str] = {}
        if tripped is None:
            with self._lock:
                tripped = tuple(self._tripped)
        for name in tripped:
            p = self._by_name[name]
            if p.env_var is not None:
                env[p.env_var] = p.env_off
            if p.cfg_field is not None:
                if isinstance(p.cfg_fallback, Mapping):
                    cur = getattr(cfg, p.cfg_field)
                    new = p.cfg_fallback.get(cur, cur)
                else:
                    new = p.cfg_fallback
                overrides[p.cfg_field] = new
        run_cfg = (cfg if not overrides
                   else type(cfg)(**{**cfg.__dict__, **overrides}))
        return run_cfg, env

    def plain_cfg(self, cfg):
        """``cfg`` with every ladder switch at its fallback, independent of
        the current trip set: the parity canary's reference program, which
        the session runs on the CPU, where every kernel wrapper runs its
        plain version."""
        return self.apply(cfg, tripped=tuple(p.name for p in self.ladder))

    # -- reporting --------------------------------------------------------

    def status(self) -> Dict:
        with self._lock:
            return {
                "ladder": [p.name for p in self.ladder],
                "tripped": {
                    name: {"reason": r.reason, "error": r.error,
                           "count": r.count, "at": r.at}
                    for name, r in self._tripped.items()},
                "trip_count": sum(r.count for r in self._tripped.values()),
                "exhausted": self._at_bottom(),
                "kernels_only": self.kernels_only,
            }

    def status_with_heal(self) -> Dict:
        """``status()`` plus the r22 probation block (kept separate so
        pre-r22 status pins stay byte-stable)."""
        doc = self.status()
        doc["heal"] = self.heal_status()
        return doc
