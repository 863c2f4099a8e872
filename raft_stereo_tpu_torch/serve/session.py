"""InferenceSession: a model, its config and a bounded cache of programs.

The port's counterpart of the JAX package's ``serve/session.py``. The
session owns:

- **shape bucketing**: every admitted pair is padded on the host
  (``InputPadder.pad_np``) onto a multiple-of-``bucket`` shape, so request
  sizes collapse onto a few programs (``bucket=32`` is the reference's
  per-shape padding);
- **an LRU-bounded program cache** keyed by *(program kind, batch, padded
  shape, iterations, config fingerprint)*. The fingerprint covers every
  config field and the value of every switch of
  ``analysis/knobs.py:ENV_KNOBS`` (breaker trips are projected into both),
  so two configurations never share a program;
- **per-key build locks**: two concurrent first requests for one bucket
  build once;
- **output validation** on the host: a non-finite disparity is a structured
  ``InferenceFailed('nonfinite_output')``, never a served frame;
- **the circuit breaker** (``serve/guard.py``): a classified kernel failure
  trips one rung, the session rebuilds and serves the request again; an
  optional **parity canary** holds the card's program against the plain
  program on the CPU within the canary band. On the card the breaker is
  ``kernels_only``: a failure whose rung would fall back to plain PyTorch is
  ``InferenceFailed('kernel_failed')`` (``'canary_failed'`` for a canary
  mismatch), so no served frame leaves the hand-written kernels.

**A program on the card is a CUDA graph.** The JAX session compiles one
program per cache key; this one captures one graph per key. At a program's
first call its Python runs once on a side stream (the warm-up, which builds
the kernels and sets their shared-memory attributes), then once more under
``torch.cuda.graph`` into a private memory pool. Static input buffers take
the padded pair or the carry: each call copies its inputs in, replays the
graph and copies the static outputs out (to the host, or into fresh device
tensors for a carry). Nothing on the model path synchronizes with the host,
and the output is checked only after the copy out, outside the captured
region. A failure while capturing is an error: no program runs uncaptured
on the card. Evicting a program frees its graph and pool. Captures run
alone on the card and replays share it (``_CaptureGate``): a capture fails
on another thread's allocation or synchronizing copy.

**On the CPU there are no graphs**: the same program runs eagerly on every
call, with the kernels' plain versions, which is how the tests run it.

The kernel switches are read when a program's Python runs: at the warm-up
and capture on the card, at every call on the CPU. Both happen under one
process-wide lock with the program's own resolved switch set exported, so
what runs is what the key says.

**Batched programs** (``max_batch > 1``) serve the continuous-batching
scheduler (``serve/scheduler.py``): ``prepare``, ``prepare_warm``,
``advance`` and ``epilogue`` are built at every batch bucket (the batch is
part of the cache key), and the warm-up builds them all for each warm-up
shape. A batched ``prepare`` runs its rows one at a time, the B=1 prepare
for each, and stacks the carries (all inside the one captured graph): the
encoder kernels take one image at a time, and a B>1 encoder would run
cuDNN convolutions and torch norms, the plain route the card's breaker
exists never to serve. A row's carry is so bit for bit its B=1 prepare's.
``advance`` and ``epilogue`` run the whole batch: the loop kernels take it
in one launch each. The session drives one card (``mesh_data`` 1); the pod
mesh is not ported.

All faults are plan-driven (``faults.ServeFaultPlan``), so every recovery
path here is testable on the CPU with deterministic injected faults.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import logging
import os
import platform
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch import kernels
from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS as _ENV_KNOBS
from raft_stereo_tpu_torch.config import RAFTStereoConfig, resolve_device
from raft_stereo_tpu_torch.faults import (RealClock, ServeFaultPlan, ServeFaults,
                                          poison_disparity)
from raft_stereo_tpu_torch.models.raft_stereo import (
    RAFTStereo, _map_carry, raft_stereo_epilogue, raft_stereo_forward,
    raft_stereo_prepare, raft_stereo_segment, raft_stereo_segment_carry,
    stack_refinement_states)
from raft_stereo_tpu_torch.obs.capacity import resolve_capacity_window_s
from raft_stereo_tpu_torch.obs.deck import TickDeck
from raft_stereo_tpu_torch.obs.flight import FlightRecorder
from raft_stereo_tpu_torch.obs.ledger import (ProgramLedger, count_flops, hbm_capacity,
                                              ledger_id, program_twin)
from raft_stereo_tpu_torch.obs.metrics import MetricsRegistry
from raft_stereo_tpu_torch.obs.profiler import ProfilerWindow
from raft_stereo_tpu_torch.obs.tracing import NULL_TRACE, Tracer
from raft_stereo_tpu_torch.obs.usage import DEFAULT_TENANT, UsageAccountant
from raft_stereo_tpu_torch.ops.padder import InputPadder
from raft_stereo_tpu_torch.serve import degrade
from raft_stereo_tpu_torch.serve.guard import (CANARY_ATOL, CANARY_RTOL, CAPTURE_PHASE,
                                               KernelCircuitBreaker, fatal_code,
                                               is_kernel_failure)
from raft_stereo_tpu_torch.serve.heal import (resolve_heal_backoff_max_ms,
                                              resolve_heal_backoff_ms, resolve_heal_enabled,
                                              resolve_heal_flap_cap, resolve_heal_window_ms)
from raft_stereo_tpu_torch.serve.supervise import InvocationWatch
from raft_stereo_tpu_torch.serve.validate import AdmissionConfig, validate_pair

logger = logging.getLogger(__name__)

# A program's Python reads the kernel switches from the process environment,
# so the windows in which one runs with its switch set exported (a capture on
# the card, every call on the CPU) are serialized across all programs.
_ENV_LOCK = threading.Lock()


class _CaptureGate:
    """The card's programs, process-wide: any number of calls copy in,
    replay and copy out at once; a capture, or a graph's release, runs
    alone. ``torch.cuda.graph`` captures in CUDA's global mode, in which
    another thread's allocation or synchronizing copy (a replay's copy in
    or out) invalidates the capture. A waiting capture goes before new
    replays."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._alone = False
        self._waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._alone or self._waiting:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def alone(self):
        with self._cond:
            self._waiting += 1
            while self._alone or self._shared:
                self._cond.wait()
            self._waiting -= 1
            self._alone = True
        try:
            yield
        finally:
            with self._cond:
                self._alone = False
                self._cond.notify_all()


_GATE = _CaptureGate()


class SessionError(RuntimeError):
    """Structured serving failure; ``code`` is machine-readable."""

    def __init__(self, code: str, message: str):
        self.code = code
        super().__init__(message)


class InferenceFailed(SessionError):
    """The forward ran but its result cannot be served (non-finite
    disparity), every fallback rung failed (``ladder_exhausted``), the
    failure's rung would leave the hand-written kernels on the card
    (``kernel_failed``; ``canary_failed`` for a canary mismatch), the CUDA
    context is lost (``cuda_sticky_error``) or a program could not be
    captured (``capture_failed``)."""


class DeadlineExceeded(SessionError):
    def __init__(self, message: str):
        super().__init__("deadline_exceeded", message)


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Serving knobs, orthogonal to the model config (the JAX package's).

    valid_iters: refinement iterations for an undegraded request.
    segments: how many host-visible chunks a deadline-carrying request
        splits ``valid_iters`` into (must divide it).
    bucket: pad request shapes up to multiples of this (a multiple of 32).
    max_programs: LRU bound on cached programs; at least the programs the
        warm-up and the canary build (``warmup_programs``), so that the
        warm-up keeps its own.
    warmup_shapes: (H, W) image shapes whose full programs are built at
        construction.
    warmup_segmented: also build the prepare/segment programs for each
        warm-up shape and its half-resolution bucket.
    canary: run the parity canary at construction (the card's program
        against the plain program on the CPU, in the canary band; a
        mismatch trips the breaker).
    canary_shape / canary_iters: geometry of the canary forward.
    allow_half_res: let the degrade policy drop to half resolution when the
        budget cannot fit even one full-resolution segment.
    max_batch: the continuous-batching scheduler's device-batch ceiling
        (1: the sequential path, no batched program is built). With more,
        the LRU bound is raised to hold one warm shape bucket's batched
        programs (``4 * len(batch_buckets) + 2``).
    batch_buckets: the batch sizes programs are built at; a batch pads up
        to the smallest that fits. Empty: ``RAFT_BATCH_BUCKETS`` if set,
        else powers of two up to ``max_batch``.
    mesh_data: None or 1. The pod mesh is one process per card; more
        raises.
    heal: the recovery plane's switch (None: ``RAFT_HEAL``, else on).
    """

    valid_iters: int = 32
    segments: int = 4
    bucket: int = 32
    max_programs: int = 8
    warmup_shapes: Tuple[Tuple[int, int], ...] = ()
    warmup_segmented: bool = False
    canary: bool = False
    canary_shape: Tuple[int, int] = (64, 96)
    canary_iters: int = 2
    allow_half_res: bool = True
    max_batch: int = 1
    batch_buckets: Tuple[int, ...] = ()
    mesh_data: Optional[int] = None
    heal: Optional[bool] = None
    admission: AdmissionConfig = dataclasses.field(default_factory=AdmissionConfig)

    def __post_init__(self):
        if self.bucket % 32:
            raise ValueError(f"bucket must be a multiple of 32, got {self.bucket}")
        if self.valid_iters % self.segments:
            raise ValueError(f"segments ({self.segments}) must divide valid_iters "
                             f"({self.valid_iters})")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.batch_buckets:
            bb = tuple(self.batch_buckets)
            if list(bb) != sorted(set(bb)) or bb[0] < 1:
                raise ValueError(f"batch_buckets must be strictly increasing positive "
                                 f"ints, got {bb}")
        if self.mesh_data not in (None, 1):
            raise NotImplementedError(
                f"mesh_data={self.mesh_data}: the port's session drives one card; "
                "the pod mesh is one process per card")
        if self.max_batch == 1 and self.max_programs < self.warmup_programs:
            raise ValueError(f"max_programs={self.max_programs} is below the "
                             f"{self.warmup_programs} programs the warm-up and the "
                             "canary build")

    @property
    def warmup_programs(self) -> int:
        """The programs built at construction at ``max_batch`` 1: a full
        program for each warm-up shape, with ``warmup_segmented`` its
        prepare and segment and those of its half bucket, and the canary's.
        (Batched sessions count theirs against the session's own bound,
        which depends on the resolved batch buckets.)"""
        per_shape = 1 + (2 + 2 * self.allow_half_res) * self.warmup_segmented
        return len(self.warmup_shapes) * per_shape + self.canary


@dataclasses.dataclass
class InferenceResult:
    """One served disparity field with an honest quality label.
    ``tripped`` names the breaker rungs this request tripped on its way."""

    disparity: np.ndarray        # (H, W) float32, positive disparity
    quality: str                 # 'full' | 'reduced_iters:<k>' | 'half_res'
    iters: int                   # refinement iterations actually run
    elapsed_s: float
    padded_shape: Tuple[int, int]
    deadline_missed: bool = False
    tripped: Tuple[str, ...] = ()

    @property
    def degraded(self) -> bool:
        return self.quality != "full"


@contextlib.contextmanager
def _env_overrides(env: Dict[str, Optional[str]]):
    """Export a fully resolved switch set while a program's Python runs.
    ``None`` means unset, so the program sees exactly the values it was
    keyed under."""
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def resolve_env(overrides: Dict[str, str],
                base: Optional[Dict[str, Optional[str]]] = None
                ) -> Dict[str, Optional[str]]:
    """A full kernel-switch mapping: the breaker override where present,
    the ``base`` snapshot otherwise (``None`` value = unset; ``base=None``
    reads the live environment). Both the cache key and the program's run
    use this mapping. Override keys outside ``ENV_KNOBS`` are kept: a rung
    with a new switch must reach the program."""
    keys = tuple(_ENV_KNOBS) + tuple(k for k in overrides if k not in _ENV_KNOBS)
    if base is None:
        base = {k: os.environ.get(k) for k in keys}
    return {k: (overrides[k] if k in overrides else base.get(k)) for k in keys}


def config_fingerprint(cfg: RAFTStereoConfig, env: Dict[str, str]) -> Tuple:
    """Every forward-relevant degree of freedom, hashable: all config
    fields and the effective value of each kernel switch (pass a
    :func:`resolve_env` mapping to pin one snapshot)."""
    cfg_part = tuple(sorted((f.name, repr(getattr(cfg, f.name)))
                            for f in dataclasses.fields(cfg)))
    if set(env) >= set(_ENV_KNOBS):  # already a resolve_env snapshot
        env_part = tuple(sorted(env.items()))
    else:
        env_part = tuple(sorted(resolve_env(env).items()))
    return cfg_part, env_part


# Session counters (obs/metrics.py registry): the short names status()
# reports, mapped to their Prometheus series' help.
_SESSION_COUNTERS = {
    "compiles": "programs built (a CUDA graph each on the card)",
    "evictions": "programs evicted from the LRU cache",
    "requests_ok": "requests served with a finite disparity",
    "requests_failed": "requests that raised",
    "degraded": "served requests whose quality label was not 'full'",
    "nonfinite_outputs": "forwards whose disparity failed validation",
    "rebuilds": "breaker-driven session rebuilds (one rung down)",
    "trips": "breaker rungs tripped by this session",
}

# Config fields that leave the weights as they are: a session may serve a
# model under values of these other than its own.
_WEIGHT_FREE = ("corr_implementation", "mixed_precision", "slow_fast_gru")

# Every serving program kind, the JAX package's list.
PROGRAM_KINDS = ("full", "prepare", "prepare_warm", "segment", "advance", "epilogue")


def build_program(kind: str, model: RAFTStereo, iters: int):
    """The callable of one serving program kind on ``model`` (whose
    ``cfg`` is the program's config). Inputs and outputs are tensors and
    carries; every program returns a tuple. The session captures exactly
    this callable on the card and calls it on the CPU."""
    if kind == "full":
        def fwd(image1, image2):
            _, flow_up = raft_stereo_forward(model, image1, image2, iters=iters)
            return flow_up, flow_up.float().sum()
        return fwd
    if kind == "prepare":
        def prep(image1, image2):
            return (_prepare_rows(model, image1, image2),)
        return prep
    if kind == "prepare_warm":
        # Streaming warm start: coords1 seeded from an x-only 1/f flow
        # (b, h/f, w/f, 1); the y channel is made here as zeros, so the
        # carry keeps flow y == 0 and rides the cold carries' advance and
        # epilogue programs (the kernels' motion encoder drops flow y).
        def prep_warm(image1, image2, flow_x):
            flow_init = torch.cat([flow_x.float(), torch.zeros_like(flow_x)], dim=-1)
            return (_prepare_rows(model, image1, image2, flow_init),)
        return prep_warm
    if kind == "segment":
        def seg(state):
            state, _, flow_up = raft_stereo_segment(model, state, iters=iters)
            return state, flow_up, flow_up.float().sum()
        return seg
    if kind == "advance":
        def adv(state):
            state, dnorm = raft_stereo_segment_carry(model, state, iters=iters)
            rowsum = state["coords1"].float().sum(dim=(1, 2, 3))
            return state, rowsum, dnorm
        return adv
    if kind == "epilogue":
        def epi(state):
            flow_low, flow_up = raft_stereo_epilogue(model, state)
            return flow_up, flow_low[..., :1].float()
        return epi
    raise ValueError(f"unknown program kind {kind!r}")


def _prepare_rows(model: RAFTStereo, image1, image2, flow_init=None) -> dict:
    """The prepare step, one row at a time: each row's carry is its B=1
    prepare's, bit for bit, and the encoder kernels (B=1 only) run for
    every row; the carries are stacked along the batch."""
    if image1.shape[0] == 1:
        return raft_stereo_prepare(model, image1, image2, flow_init=flow_init)
    return stack_refinement_states([
        raft_stereo_prepare(model, image1[i:i + 1], image2[i:i + 1],
                            flow_init=None if flow_init is None else flow_init[i:i + 1])
        for i in range(image1.shape[0])])


def _static_like(arg, device: torch.device):
    """An uninitialized device buffer of ``arg``'s structure: a tensor for
    an array, a carry of tensors for a carry."""
    if isinstance(arg, np.ndarray):
        return torch.empty(arg.shape, dtype=torch.from_numpy(arg).dtype, device=device)
    return _map_carry(lambda x: torch.empty_like(x, device=device), arg)


def _copy_into(static, arg) -> None:
    if isinstance(arg, np.ndarray):
        static.copy_(torch.from_numpy(arg))
    else:
        _map_carry(lambda dst, src: dst.copy_(src), static, arg)


def _as_input(arg):
    """An eager program's input: host arrays as CPU tensors, carries as
    they are."""
    return torch.from_numpy(arg) if isinstance(arg, np.ndarray) else arg


def _fetch(outputs, clone: bool) -> tuple:
    """Tensors to host numpy (the copy is the completion barrier); carries
    stay on the device, cloned when they are a graph's static outputs (the
    next replay overwrites those)."""
    return tuple((_map_carry(torch.clone, o) if clone else o) if isinstance(o, dict)
                 else o.cpu().numpy() for o in outputs)


def _nbytes(arg) -> int:
    if isinstance(arg, np.ndarray):
        return arg.nbytes
    total = []
    _map_carry(lambda x: total.append(x.numel() * x.element_size()), arg)
    return sum(total)


class _Program:
    """One cached program and its lock. ``env`` is the switch set its
    Python runs under. On the card, ``graph`` is its CUDA graph once
    captured, with its static buffers, the launches each kernel wrapper made
    while it was captured (a replay makes the same launches and counts
    none), and the capture's seconds and pool bytes."""

    __slots__ = ("key", "fn", "kind", "env", "warmed", "lock", "ledger_id", "graph",
                 "static_in", "static_out", "launches", "variants", "capture_s",
                 "pool_bytes")

    def __init__(self, key, fn, kind, env):
        self.key = key
        self.fn = fn
        self.kind = kind
        self.env = dict(env)
        self.warmed = False
        # Held for the capture and for every replay: the static buffers
        # serve one call at a time, and eviction waits for the call.
        self.lock = threading.Lock()
        self.ledger_id = ledger_id(key)
        self.graph = None
        self.static_in = self.static_out = None
        self.launches: Dict[str, int] = {}
        self.variants: Dict[str, int] = {}
        self.capture_s: Optional[float] = None
        self.pool_bytes: Optional[float] = None

    def copy_in(self, args) -> None:
        for static, arg in zip(self.static_in, args):
            _copy_into(static, arg)

    def replay(self) -> None:
        self.graph.replay()

    def copy_out(self) -> tuple:
        return _fetch(self.static_out, clone=True)

    def release(self) -> None:
        """Free the graph and its pool; a later call captures again."""
        with self.lock:
            if self.graph is not None:
                with _GATE.alone():
                    self.graph.reset()
            self.graph = self.static_in = self.static_out = None
            self.warmed = False


class InferenceSession:
    """Owns a model and its config; admits arbitrary pairs, serves
    disparity.

    ``model`` is a :class:`RAFTStereo` (its weights; the session moves it to
    ``device``); ``cfg`` is the configuration to serve, of the model's
    architecture (the correlation, the precision and ``slow_fast_gru`` may
    differ from the model's own). ``device=None`` is the card
    (``resolve_device``), which raises where there is none: the session
    never falls back to the CPU.
    """

    def __init__(self, model: RAFTStereo, cfg: RAFTStereoConfig,
                 session_cfg: Optional[SessionConfig] = None, *, device=None,
                 fault_plan: Optional[ServeFaultPlan] = None, clock=None,
                 breaker: Optional[KernelCircuitBreaker] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 ledger: Optional[ProgramLedger] = None,
                 flight: Optional[FlightRecorder] = None):
        arch = [f.name for f in dataclasses.fields(cfg) if f.name not in _WEIGHT_FREE]
        if any(getattr(cfg, n) != getattr(model.cfg, n) for n in arch):
            raise ValueError(f"cfg's architecture differs from the model's: {cfg} vs "
                             f"{model.cfg}")
        self.device = resolve_device(device)
        self._graphs = self.device.type == "cuda"
        self._model = model.to(self.device).eval()
        self._cpu_model: Optional[RAFTStereo] = None
        self.cfg = session_cfg or SessionConfig()
        self.clock = clock if clock is not None else RealClock()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(clock=self.clock)
        self.profiler = ProfilerWindow()  # RAFT_PROFILE_DIR, read once
        self.ledger = ledger if ledger is not None else ProgramLedger()
        self.flight = flight if flight is not None else FlightRecorder()
        self.deck = TickDeck(clock=self.clock)
        self.usage = UsageAccountant(self.registry)
        self._capacity_window_s = resolve_capacity_window_s()
        self._usage_tl = threading.local()
        self._backend = self.device.type
        self._device_kind = (torch.cuda.get_device_name(self.device) if self._graphs
                             else None)
        self._hbm_lock = threading.Lock()
        self._hbm_buckets: set = set()
        self._ctr = {name: self.registry.counter(f"raft_session_{name}_total", help)
                     for name, help in _SESSION_COUNTERS.items()}
        self._base_cfg = cfg
        # Kernel switches are captured once, here: every cache key and every
        # program run resolves against this snapshot (plus breaker
        # overrides). Changing switches means a new session or a trip.
        self._env_base: Dict[str, Optional[str]] = {k: os.environ.get(k) for k in _ENV_KNOBS}
        # On the card no rung may leave the hand-written kernels.
        self.breaker = breaker or KernelCircuitBreaker(kernels_only=self._graphs)
        if self._graphs and not self.breaker.kernels_only:
            raise ValueError("a session on the card needs a kernels_only breaker: no "
                             "served frame may fall back to plain PyTorch")
        self.breaker.bind_registry(self.registry)
        self._heal_enabled = resolve_heal_enabled(self.cfg.heal)
        self.breaker.configure_heal(
            enabled=self._heal_enabled, clock=self.clock,
            backoff_s=resolve_heal_backoff_ms() / 1e3,
            backoff_max_s=resolve_heal_backoff_max_ms() / 1e3)
        self._heal_backoff_s = resolve_heal_backoff_ms() / 1e3
        self._heal_backoff_max_s = resolve_heal_backoff_max_ms() / 1e3
        self._heal_flap_cap = resolve_heal_flap_cap()
        self._heal_window_s = resolve_heal_window_ms() / 1e3
        # The batch-bucket ladder, resolved once (SessionConfig >
        # RAFT_BATCH_BUCKETS > powers of two up to max_batch): the batch is
        # a cache-key component, so this selects which batch sizes are
        # built, never what one program computes.
        self._batch_buckets = self._resolve_batch_buckets()
        # With max_batch > 1 the LRU bound holds one warm shape bucket's
        # batched programs (prepare, prepare_warm, advance, epilogue at
        # every batch bucket) and two more, or the warm-up would evict its
        # own programs and the scheduler would capture again every tick.
        self._max_programs = self.cfg.max_programs
        if self.cfg.max_batch > 1:
            self._max_programs = max(self.cfg.max_programs, 4 * len(self._batch_buckets) + 2)
            need = (len(self.cfg.warmup_shapes) * (1 + 4 * len(self._batch_buckets))
                    + self.cfg.canary)
            if self._max_programs < need:
                raise ValueError(f"max_programs={self._max_programs} is below the {need} "
                                 "programs the batched warm-up and the canary build")
        self.faults = ServeFaults(fault_plan, clock=self.clock)
        self.watch = InvocationWatch(self.clock)
        self._cache: "OrderedDict[Tuple, _Program]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self._key_locks: Dict[Tuple, threading.Lock] = {}
        self._estimates: Dict[Tuple, float] = {}
        self._est_lock = threading.Lock()
        self._canary_state = {"enabled": self.cfg.canary, "ran": False,
                              "passed": None, "attempts": 0}
        self._canary_refs: Dict[Tuple, np.ndarray] = {}
        # A sticky CUDA error leaves the context unusable: (code, message)
        # of the first one, after which every request fails fast.
        self._fatal: Optional[Tuple[str, str]] = None
        self._run_cfg, self._env = self.breaker.apply(cfg)
        self.registry.set_build_info(fingerprint=self.fingerprint_id(),
                                     python=platform.python_version(),
                                     torch=torch.__version__, backend=self._backend)
        if self._graphs:
            kernels.build()  # every source at once, before the first capture
            self._stream = torch.cuda.Stream(self.device)
        self.start()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Build the configured buckets and run the parity canary. Called
        from the constructor; kernel failures here already walk the ladder,
        so a session whose fast paths are broken comes up degraded."""
        for (h, w) in self.cfg.warmup_shapes:
            self._warm_shape(h, w)
        if self.cfg.canary:
            self._run_canary()

    def _rebuild(self, why: str) -> None:
        """Project the new trip set onto the run config. Programs keyed
        under the old fingerprint become unreachable and age out of the
        LRU; they are never served for the new config."""
        self._run_cfg, self._env = self.breaker.apply(self._base_cfg)
        self._ctr["rebuilds"].inc()
        logger.warning("session rebuilt one rung down (%s); tripped=%s",
                       why, list(self.breaker.tripped_names))

    def _trip(self, name: str, reason: str, exc=None) -> None:
        self.breaker.trip(name, reason, exc)
        self._ctr["trips"].inc()
        logger.warning("breaker tripped rung %s (%s): %s", name, reason, exc)

    def _raise_fatal(self, exc: Exception) -> None:
        """End the request in a structured error for a sticky CUDA error or
        a failed capture: no retry, no trip."""
        code = fatal_code(exc)
        if code is None:
            return
        if code == "cuda_sticky_error" and self._fatal is None:
            self._fatal = (code, str(exc))
        logger.error("%s: %s", code, exc)
        raise InferenceFailed(code, f"{code}: {exc}") from exc

    def _rung_for(self, exc: Exception, refused_code: str):
        """The rung a failure trips; a structured error where there is none
        (``ladder_exhausted``) or where the breaker refuses it
        (``refused_code``: the rung would leave the hand-written kernels)."""
        path = self.breaker.classify(exc)
        if path is None:
            raise InferenceFailed("ladder_exhausted",
                                  f"bottom-rung program still failing: {exc}") from exc
        if self.breaker.refuses(path):
            logger.error("%s: rung %s would fall back to plain PyTorch; not tripped: %s",
                         refused_code, path.name, exc)
            raise InferenceFailed(refused_code, f"{refused_code}: {exc} (its rung "
                                  f"{path.name} would leave the hand-written kernels)"
                                  ) from exc
        return path

    def _breaker_retry(self, exc: Exception, phase: str, traces=()) -> str:
        """Classify a kernel failure, trip the rung, rebuild; or give up
        with a structured error when the ladder is exhausted. Returns the
        rung tripped."""
        path = self._rung_for(exc, "kernel_failed")
        self._trip(path.name, phase, exc)
        for trace in traces:
            trace.event("breaker_trip", rung=path.name, phase=phase)
        self._rebuild(f"{path.name}: {exc}")
        return path.name

    def _handle_failure(self, exc: Exception, traces=()) -> str:
        """The one recovery step of every retry loop: a fatal failure ends
        in a structured error, anything but a kernel failure propagates,
        and a kernel failure trips one rung (returned)."""
        if isinstance(exc, SessionError):
            raise exc
        self._raise_fatal(exc)
        if not is_kernel_failure(exc):
            raise exc
        return self._breaker_retry(exc, getattr(exc, "_raft_phase", "runtime_failure"),
                                   traces=traces)

    # -- padding ----------------------------------------------------------

    def padder_for(self, shape) -> InputPadder:
        return InputPadder(shape, divis_by=32, bucket=self.cfg.bucket)

    def _resolve_batch_buckets(self) -> Tuple[int, ...]:
        buckets = tuple(self.cfg.batch_buckets)
        if not buckets:
            spec = os.environ.get("RAFT_BATCH_BUCKETS", "").strip()
            if spec:
                try:
                    buckets = tuple(sorted({int(p) for p in spec.split(",") if p.strip()}))
                except ValueError:
                    raise ValueError(f"RAFT_BATCH_BUCKETS must be comma-separated positive "
                                     f"ints, got {spec!r}") from None
                if not buckets or buckets[0] < 1:
                    raise ValueError(f"RAFT_BATCH_BUCKETS must be positive ints, got {spec!r}")
            else:
                powers, b = [], 1
                while b < self.cfg.max_batch:
                    powers.append(b)
                    b *= 2
                buckets = tuple(powers) + (self.cfg.max_batch,)
        # Capped at max_batch, keeping one bucket that covers it.
        capped = tuple(b for b in buckets if b < self.cfg.max_batch)
        covering = min((b for b in buckets if b >= self.cfg.max_batch),
                       default=self.cfg.max_batch)
        return capped + (covering,)

    @property
    def batch_buckets(self) -> Tuple[int, ...]:
        return self._batch_buckets

    def batch_bucket(self, n: int) -> int:
        """The smallest batch bucket that fits ``n`` rows."""
        for b in self._batch_buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds the largest batch bucket "
                         f"{self._batch_buckets[-1]} (max_batch={self.cfg.max_batch})")

    # The pod mesh is not ported: one card, so the service's mesh branches
    # (chip probes and quarantine on a device hang) are never taken.
    @property
    def mesh_active(self) -> bool:
        return False

    @property
    def mesh_chips(self) -> int:
        return 1

    @contextlib.contextmanager
    def device_ops(self):
        """Around device work done outside a program (the scheduler's row
        gathers and joins, the uploader's copies): on the card it shares
        the card with replays and waits out a capture (``_CaptureGate``),
        which another thread's allocation or synchronizing copy would
        invalidate. Never hold it across :meth:`invoke`."""
        if not self._graphs:
            yield
            return
        with _GATE.shared():
            yield

    # -- program cache ----------------------------------------------------

    def _resolve(self, env: Dict[str, str]) -> Dict[str, Optional[str]]:
        return resolve_env(env, self._env_base)

    def _fingerprint(self, cfg=None, env=None) -> Tuple:
        env = env if env is not None else self._env
        if not (set(env) >= set(_ENV_KNOBS)):
            env = self._resolve(env)
        return config_fingerprint(cfg if cfg is not None else self._run_cfg, env)

    def cache_key(self, kind: str, h: int, w: int, iters: int,
                  cfg=None, env=None, b: int = 1) -> Tuple:
        return (kind, b, h, w, iters, self._fingerprint(cfg, env))

    def fingerprint_id(self) -> str:
        """Short stable hash of the current run fingerprint; an effective
        breaker trip changes it, as it changes the keys."""
        return hashlib.sha256(repr(self._fingerprint()).encode()).hexdigest()[:12]

    @contextlib.contextmanager
    def usage_riders(self, labels):
        """Bind the tenant labels of the rows riding the next device calls on
        this thread (obs/usage.py); nesting restores the previous binding."""
        prev = getattr(self._usage_tl, "labels", None)
        self._usage_tl.labels = list(labels) or None
        try:
            yield
        finally:
            self._usage_tl.labels = prev

    def get_program(self, kind: str, h: int, w: int, iters: int,
                    cfg=None, env=None, b: int = 1) -> _Program:
        """Fetch or build under the per-key lock; LRU-bounded. The switch
        set is resolved once here, and that snapshot both keys the program
        and is exported while its Python runs."""
        cfg = cfg if cfg is not None else self._run_cfg
        env = env if env is not None else self._env
        run_env = self._resolve(env)
        key = self.cache_key(kind, h, w, iters, cfg, run_env, b=b)
        with self._cache_lock:
            prog = self._cache.get(key)
            if prog is not None:
                self._cache.move_to_end(key)
                return prog
            lock = self._key_locks.setdefault(key, threading.Lock())
        with lock:
            with self._cache_lock:  # double-checked: the loser of the race
                prog = self._cache.get(key)
                if prog is not None:
                    self._cache.move_to_end(key)
                    return prog
            try:
                self.faults.on_build()  # an injected build failure fires here
                fn = build_program(kind, _view(self._model, cfg), iters)
            except Exception as e:
                setattr(e, "_raft_phase", "compile_failure")
                with self._cache_lock:
                    self._key_locks.pop(key, None)
                raise
            self._ctr["compiles"].inc()
            prog = _Program(key, fn, kind, run_env)
            evicted = []
            with self._cache_lock:
                self._cache[key] = prog
                while len(self._cache) > self._max_programs:
                    old_key, old = self._cache.popitem(last=False)
                    self._key_locks.pop(old_key, None)
                    with self._est_lock:
                        self._estimates.pop(old_key, None)
                    evicted.append(old)
            if evicted:
                self._ctr["evictions"].inc(len(evicted))
                for old in evicted:
                    old.release()
                    row = self.ledger.drop(old.key)
                    peak = row.peak_hbm_bytes if row is not None else None
                    logger.info("evicted program %s from the LRU cache (peak %s)",
                                old.ledger_id,
                                f"{peak / 2**20:.1f} MiB" if peak else "unknown")
                self._refresh_cache_hbm()
            return prog

    def has_program(self, kind: str, h: int, w: int, iters: int, b: int = 1) -> bool:
        """Whether this program is built and has run (no side effects): the
        degrade policy never routes a deadline request onto a cold bucket."""
        key = self.cache_key(kind, h, w, iters, b=b)
        with self._cache_lock:
            prog = self._cache.get(key)
        return prog is not None and prog.warmed

    def _twin_flops(self, prog: _Program) -> Optional[float]:
        """The fp32 twin's flop count for a program (obs/ledger.py)."""
        kind, b, h, w, iters = prog.key[:5]
        return _twin_flops(kind, b, h, w, iters,
                           tuple(sorted(dataclasses.asdict(self._base_cfg).items())))

    def _record(self, prog: _Program, analysis: Dict) -> None:
        kind, b, h, w, iters = prog.key[:5]
        self.ledger.record(prog.key, kind=kind, b=b, h=h, w=w, iters=iters, scan_scale=1,
                           analysis=analysis, backend=self._backend,
                           device_kind=self._device_kind)

    def _capture(self, prog: _Program, args) -> None:
        """Build ``prog``'s CUDA graph with ``args`` as its first inputs:
        static buffers, a warm-up on the session's side stream, the capture
        on the same stream, then the ledger row. Called under ``prog.lock``,
        ``_ENV_LOCK`` with the program's switches exported, and the gate
        alone."""
        dev = self.device
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        prog.static_in = tuple(_static_like(a, dev) for a in args)
        prog.copy_in(args)
        arg_bytes = float(sum(_nbytes(a) for a in args))
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            prog.fn(*prog.static_in)  # warm-up: kernels built, attributes set
        torch.cuda.synchronize(dev)
        # torch.cuda.graph empties the allocator's cache as it opens; done
        # here first, the reserved bytes it adds are the graph's pool alone.
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        launches, variants = dict(kernels.launches), dict(kernels.variants)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                prog.static_out = prog.fn(*prog.static_in)
        except Exception as e:
            prog.static_in = prog.static_out = None
            setattr(e, "_raft_phase", CAPTURE_PHASE)
            raise
        prog.capture_s = time.perf_counter() - t0
        prog.graph = graph
        prog.launches = {k: n - launches.get(k, 0) for k, n in kernels.launches.items()
                         if n != launches.get(k, 0)}
        prog.variants = {k: n - variants.get(k, 0) for k, n in kernels.variants.items()
                         if n != variants.get(k, 0)}
        prog.pool_bytes = float(torch.cuda.memory_reserved(dev) - reserved)
        peak = float(torch.cuda.max_memory_allocated(dev) - start)
        self._record(prog, {"flops": self._twin_flops(prog), "argument_bytes": arg_bytes,
                            "temp_bytes": max(peak - arg_bytes, 0.0),
                            "capture_s": prog.capture_s,
                            "graph_pool_bytes": prog.pool_bytes})

    def _run(self, prog: _Program, args) -> Tuple[tuple, float]:
        """One call of ``prog``: (outputs, the session-clock time its inputs
        were in and its work dispatched)."""
        if not self._graphs:
            inputs = [_as_input(a) for a in args]
            with prog.lock:
                if not prog.warmed:
                    self._record(prog, {"flops": self._twin_flops(prog)})
                with _ENV_LOCK, _env_overrides(prog.env):
                    raw = prog.fn(*inputs)
                    t_disp = self.clock.now()
                prog.warmed = True
            return _fetch(raw, clone=False), t_disp
        with prog.lock:
            fresh = prog.graph is None
            if fresh:
                with _ENV_LOCK, _env_overrides(prog.env), _GATE.alone():
                    self._capture(prog, args)  # copies ``args`` in
            with _GATE.shared():
                if not fresh:
                    prog.copy_in(args)
                prog.replay()
                t_disp = self.clock.now()
                out = prog.copy_out()
            prog.warmed = True
        return out, t_disp

    def invoke(self, prog: _Program, *args, trace=NULL_TRACE) -> tuple:
        """Run a cached program and fetch its results: arrays to the host,
        carries on the device. The first call builds it (a capture on the
        card). ``trace`` gets one span per call, named by program kind."""
        if self._fatal is not None:
            raise InferenceFailed(*self._fatal)
        was_warm = prog.warmed
        t0 = self.clock.now()
        t_disp = t0
        token = self.watch.begin(prog.ledger_id, prog.kind, warming=not was_warm,
                                 est=self.estimate(prog.key))
        try:
            self.faults.on_invoke()
            out, t_disp = self._run(prog, args)
        except Exception as e:
            if not hasattr(e, "_raft_phase"):
                setattr(e, "_raft_phase", "runtime_failure")
            raise
        finally:
            self.watch.end(token)
        if not was_warm:
            self._refresh_cache_hbm()
        ordinal = self.faults.on_forward()
        t_end = self.clock.now()  # includes any injected device time
        host_s = max(0.0, t_disp - t0)
        device_s = max(0.0, t_end - t_disp)
        _, b_key, h_key, w_key = prog.key[:4]
        self.registry.counter("raft_program_calls_total",
                              "device-program invocations by kind", kind=prog.kind).inc()
        if was_warm:
            # A first call's time includes the build (the capture): kept out
            # of the latency EMA the degrade policy reads.
            self._record_time(prog.key, t_end - t0)
            self.registry.counter("raft_program_host_seconds_total",
                                  "host-side copy-in and dispatch time by program kind",
                                  kind=prog.kind).inc(host_s)
            self.registry.counter("raft_program_device_seconds_total",
                                  "device wait (dispatch-to-fetch) by program kind",
                                  kind=prog.kind).inc(device_s)
            row = self.ledger.row(prog.key)
            if row is not None and row.flops_est:
                self.registry.counter("raft_program_flops_total",
                                      "ledger-estimated flops executed by program kind",
                                      kind=prog.kind).inc(row.flops_est)
            labels = (getattr(self._usage_tl, "labels", None)
                      or [self.usage.label(DEFAULT_TENANT)])
            self.usage.add_device(labels, device_s,
                                  flops=(row.flops_est if row is not None else None))
            tick_seq = self.deck.note_invocation(
                kind=prog.kind, program=prog.ledger_id, b=b_key, h=h_key, w=w_key, t0=t0,
                t1=t_end, host_s=host_s, device_s=device_s, warming=False)
            attrs = {"program": prog.ledger_id}
            if tick_seq is not None:
                attrs["tick"] = tick_seq
            trace.add_span(prog.kind, t0, t_end, **attrs)
        else:
            self.registry.counter("raft_program_warmup_seconds_total",
                                  "first-call (build-inclusive) time by kind",
                                  kind=prog.kind).inc(max(0.0, t_end - t0))
            self.deck.note_invocation(
                kind=prog.kind, program=prog.ledger_id, b=b_key, h=h_key, w=w_key, t0=t0,
                t1=t_end, host_s=host_s, device_s=device_s, warming=True)
            trace.add_span(prog.kind, t0, t_end, warming=True, program=prog.ledger_id)
        if self.faults.poisoned(ordinal):
            flow_i = {"full": 0, "segment": 1, "epilogue": 0}.get(prog.kind)
            if flow_i is not None:
                out = out[:flow_i] + (poison_disparity(out[flow_i]),) + out[flow_i + 1:]
        return out

    def program_launches(self, kind: str, h: int, w: int, iters: int,
                         b: int = 1) -> Dict[str, int]:
        """The kernel launches captured in this program under the current
        run config (empty on the CPU, or before its first call)."""
        key = self.cache_key(kind, h, w, iters, b=b)
        with self._cache_lock:
            prog = self._cache.get(key)
        return dict(prog.launches) if prog is not None else {}

    # -- latency estimates (EMA per program) ------------------------------

    def _record_time(self, key: Tuple, dt: float) -> None:
        with self._est_lock:
            prev = self._estimates.get(key)
            self._estimates[key] = dt if prev is None else 0.7 * prev + 0.3 * dt

    def estimate(self, key: Tuple) -> Optional[float]:
        with self._est_lock:
            return self._estimates.get(key)

    # -- serving ----------------------------------------------------------

    def infer(self, left, right, *, deadline: Optional[float] = None,
              budget_s: Optional[float] = None, allow_half_res: Optional[bool] = None,
              prevalidated: bool = False, trace=NULL_TRACE) -> InferenceResult:
        """Serve one stereo pair.

        ``deadline`` is absolute on the session clock; ``budget_s`` is
        relative sugar. With neither, the full ``valid_iters`` program runs.
        With a deadline, the refinement runs in segments and the degrade
        policy may return a reduced-iteration or half-resolution field
        (quality-labeled). Raises ``InputRejected``, :class:`DeadlineExceeded`
        or :class:`InferenceFailed`; any disparity returned is finite.
        """
        try:
            return self._infer(left, right, deadline=deadline, budget_s=budget_s,
                               allow_half_res=allow_half_res, prevalidated=prevalidated,
                               trace=trace)
        except Exception:
            self._ctr["requests_failed"].inc()
            raise

    def _infer(self, left, right, *, deadline, budget_s, allow_half_res,
               prevalidated=False, trace=NULL_TRACE) -> InferenceResult:
        t_start = self.clock.now()
        if deadline is None and budget_s is not None:
            deadline = t_start + budget_s
        if not prevalidated:
            left, right = validate_pair(left, right, self.cfg.admission)
        if deadline is not None and t_start >= deadline:
            raise DeadlineExceeded("deadline already expired on arrival")
        orig_h, orig_w = left.shape[1], left.shape[2]
        padder = self.padder_for(left.shape)
        half = self.cfg.allow_half_res if allow_half_res is None else allow_half_res
        tripped = []
        for _ in range(len(self.breaker.ladder) + 1):
            try:
                if deadline is None:
                    flow = self._run_full(padder, left, right, trace=trace)
                    out = degrade.Outcome(flow, "full", self.cfg.valid_iters, False)
                else:
                    out = degrade.run_with_deadline(self, padder, left, right, deadline,
                                                    allow_half_res=half, trace=trace)
                break
            except Exception as e:  # noqa: BLE001 — _handle_failure filters
                tripped.append(self._handle_failure(e, traces=(trace,)))
        else:
            raise InferenceFailed("ladder_exhausted",
                                  f"breaker retries exhausted, tripped {tripped}")
        with trace.span("unpad"):
            disparity = self._finish(out.flow_padded, padder, out.quality, orig_h, orig_w)
        self._ctr["requests_ok"].inc()
        if out.quality != "full":
            self._ctr["degraded"].inc()
        return InferenceResult(disparity=disparity, quality=out.quality, iters=out.iters,
                               elapsed_s=self.clock.now() - t_start,
                               padded_shape=padder.padded_shape,
                               deadline_missed=out.deadline_missed, tripped=tuple(tripped))

    def _run_full(self, padder: InputPadder, left: np.ndarray, right: np.ndarray,
                  iters: Optional[int] = None, cfg=None, env=None,
                  trace=NULL_TRACE) -> np.ndarray:
        """Single-loop forward on the padded bucket; returns the padded
        flow (1, H, W, 1)."""
        iters = iters if iters is not None else self.cfg.valid_iters
        lp, rp = padder.pad_np(left, right)
        ph, pw = padder.padded_shape
        prog = self.get_program("full", ph, pw, iters, cfg, env)
        flow_up, _checksum = self.invoke(prog, lp, rp, trace=trace)
        return flow_up

    def _finish(self, flow_padded: np.ndarray, padder: InputPadder, quality: str,
                orig_h: int, orig_w: int) -> np.ndarray:
        """Unpad, validate, convert to positive disparity."""
        flow = flow_padded if quality == "half_res" else padder.unpad_np(flow_padded)
        flow = flow[0, ..., 0]
        if flow.shape != (orig_h, orig_w):
            raise InferenceFailed("internal", f"output shape {flow.shape} != input "
                                  f"({orig_h}, {orig_w})")
        if not np.isfinite(flow).all():
            self._ctr["nonfinite_outputs"].inc()
            raise InferenceFailed("nonfinite_output",
                                  "disparity contains NaN/Inf — refusing to serve it")
        return -flow

    # -- warm-up / canary -------------------------------------------------

    def _warm_shape(self, h: int, w: int) -> None:
        """Build (and run once, on zeros) the programs of one bucket,
        walking the ladder on a kernel failure."""
        padder = self.padder_for((h, w, 3))
        zeros = np.zeros((1, h, w, 3), np.float32)
        for _ in range(len(self.breaker.ladder) + 1):
            try:
                self._run_full(padder, zeros, zeros)
                if self.cfg.max_batch > 1:
                    # The scheduler runs neither the b=1 segment program
                    # nor the half-resolution route: its programs only.
                    self._warm_batched(padder, zeros)
                elif self.cfg.warmup_segmented:
                    degrade.warm_segmented(self, padder, zeros)
                return
            except Exception as e:  # noqa: BLE001 — _handle_failure filters
                self._handle_failure(e)
        raise InferenceFailed("ladder_exhausted", f"warm-up for bucket {h}x{w} never succeeded")

    def _warm_batched(self, padder: InputPadder, zeros: np.ndarray) -> None:
        """Build and run once the continuous-batching programs of one shape
        bucket at every batch bucket: prepare, prepare_warm, advance,
        epilogue. A first call's time stays out of the estimates."""
        m = self.cfg.valid_iters // self.cfg.segments
        ph, pw = padder.padded_shape
        lp, rp = padder.pad_np(zeros, zeros)
        factor = self._run_cfg.downsample_factor
        for b in self._batch_buckets:
            lb = np.ascontiguousarray(np.concatenate([lp] * b, axis=0))
            rb = np.ascontiguousarray(np.concatenate([rp] * b, axis=0))
            (state,) = self.invoke(self.get_program("prepare", ph, pw, 0, b=b), lb, rb)
            fz = np.zeros((b, ph // factor, pw // factor, 1), np.float32)
            self.invoke(self.get_program("prepare_warm", ph, pw, 0, b=b), lb, rb, fz)
            state, _, _ = self.invoke(self.get_program("advance", ph, pw, m, b=b), state)
            self.invoke(self.get_program("epilogue", ph, pw, 0, b=b), state)

    def _canary_pair(self):
        h, w = self.cfg.canary_shape
        rng = np.random.default_rng(1234)
        left = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
        right = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
        return self.padder_for((h, w, 3)), left, right

    def _reference_flow(self, padder: InputPadder, left, right, iters: int) -> np.ndarray:
        """The canary's reference: the plain program (every rung at its
        fallback) of a CPU copy of the model, eager, where every kernel
        wrapper runs its plain version. Cached by geometry."""
        key = (padder.padded_shape, iters)
        if key not in self._canary_refs:
            if not self._graphs:
                self._cpu_model = self._model
            elif self._cpu_model is None:
                cpu = RAFTStereo(self._model.cfg)
                with _GATE.shared():  # copies from the card: never beside a capture
                    cpu.load_state_dict(self._model.state_dict())
                self._cpu_model = cpu.eval()
            ref_cfg, ref_env = self.breaker.plain_cfg(self._base_cfg)
            fn = build_program("full", _view(self._cpu_model, ref_cfg), iters)
            lp, rp = padder.pad_np(left, right)
            with _ENV_LOCK, _env_overrides(self._resolve(ref_env)):
                flow, _ = fn(torch.from_numpy(lp), torch.from_numpy(rp))
            self._canary_refs[key] = flow.numpy()
        return self._canary_refs[key]

    def _canary_ok(self, cfg=None, env=None) -> bool:
        """One canary forward of the run config (or ``cfg``/``env``)
        against the reference, in the canary band. On the CPU a run config
        that is already the plain one is its own reference: finite output
        is the whole statement."""
        padder, left, right = self._canary_pair()
        iters = self.cfg.canary_iters
        fast = self._run_full(padder, left, right, iters=iters, cfg=cfg, env=env)
        ref_cfg, ref_env = self.breaker.plain_cfg(self._base_cfg)
        if not self._graphs and self._fingerprint(cfg, env) == self._fingerprint(ref_cfg,
                                                                                ref_env):
            return bool(np.isfinite(fast).all())
        ref = self._reference_flow(padder, left, right, iters)
        return bool(np.isfinite(fast).all() and np.isfinite(ref).all()
                    and np.allclose(fast, ref, rtol=CANARY_RTOL, atol=CANARY_ATOL))

    def _run_canary(self) -> None:
        """The canary: a mismatch is a silently wrong kernel, so trip a
        rung, rebuild and check again."""
        self._canary_state["ran"] = True
        for _ in range(len(self.breaker.ladder) + 1):
            self._canary_state["attempts"] += 1
            try:
                ok = self._canary_ok()
            except Exception as e:  # noqa: BLE001 — _handle_failure filters
                self._handle_failure(e)
                continue
            if ok:
                self._canary_state["passed"] = True
                return
            try:
                path = self._rung_for(RuntimeError("canary parity mismatch"), "canary_failed")
            except InferenceFailed as e:
                self._canary_state["passed"] = False
                raise InferenceFailed("canary_failed", str(e)) from e
            self._trip(path.name, "canary_mismatch")
            self._rebuild(f"canary mismatch -> tripped {path.name}")
        self._canary_state["passed"] = False
        raise InferenceFailed("canary_failed", "canary never converged")

    def heal_status(self) -> Dict:
        """The /healthz ``heal`` block: the pacing knobs and the breaker's
        per-rung probation state (one card: no chip rows, no MTTR events)."""
        return {
            "enabled": self._heal_enabled,
            "backoff_ms": self._heal_backoff_s * 1e3,
            "backoff_max_ms": self._heal_backoff_max_s * 1e3,
            "flap_cap": self._heal_flap_cap,
            "window_ms": self._heal_window_s * 1e3,
            "breaker": self.breaker.heal_status(),
            "chips": {},
            "mttr": {"last_s": None, "events": 0},
        }

    def heal_breaker(self) -> Optional[Dict]:
        """One half-open canary probe of the most recently tripped eligible
        rung: the candidate projection (current trips minus the rung) runs
        the canary without touching serving state; a pass untrips, rebuilds
        and re-warms, a fail re-trips with a doubled backoff. None when no
        rung is eligible."""
        name = self.breaker.heal_candidate()
        if name is None:
            return None
        out: Dict = {"rung": name, "passed": False}
        cand = tuple(n for n in self.breaker.tripped_names if n != name)
        cand_cfg, cand_env = self.breaker.apply(self._base_cfg, tripped=cand)
        ok = False
        try:
            ok = self._canary_ok(cand_cfg, cand_env)
        except Exception as e:  # noqa: BLE001 — filtered just below
            self._raise_fatal(e)
            if not is_kernel_failure(e):
                raise
            out["error"] = str(e)  # the rung under probation is the suspect
        self.registry.counter("raft_heal_rung_probes_total",
                              "half-open breaker canary probes by rung and outcome",
                              rung=name, result=("passed" if ok else "failed")).inc()
        if ok:
            self.breaker.untrip(name)
            self._run_cfg, self._env = self.breaker.apply(self._base_cfg)
            self._ctr["rebuilds"].inc()
            logger.warning("heal: rung %s re-engaged after a passing canary; tripped=%s",
                           name, list(self.breaker.tripped_names))
            for (wh, ww) in self.cfg.warmup_shapes:
                self._warm_shape(wh, ww)
            out["passed"] = True
        else:
            self.breaker.trip(name, "heal_canary_failed")
        return out

    # -- device ledger / memory accounting --------------------------------

    def ledger_key_id(self, kind: str, h: int, w: int, iters: int, b: int = 1) -> str:
        """The ledger id of the program (kind, geometry, batch) resolves to
        under the current run config: the scheduler stamps it on its spans,
        so a flight record joins a request to the programs it rode."""
        return ledger_id(self.cache_key(kind, h, w, iters, b=b))

    def _cache_hbm_parts(self) -> Tuple[Dict[str, float], float, int]:
        """(by_bucket, total, unknown_rows): summed ledger peaks of the
        cached programs per shape bucket; rows without memory numbers (the
        CPU) count as unknown and contribute nothing."""
        with self._cache_lock:
            progs = list(self._cache.values())
        by_bucket: Dict[str, float] = {}
        total, unknown = 0.0, 0
        for prog in progs:
            row = self.ledger.row(prog.key)
            peak = row.peak_hbm_bytes if row is not None else None
            if peak is None:
                unknown += 1
                continue
            bucket = f"{prog.key[2]}x{prog.key[3]}"
            by_bucket[bucket] = by_bucket.get(bucket, 0.0) + peak
            total += peak
        return by_bucket, total, unknown

    def cache_hbm(self) -> Dict:
        by_bucket, total, unknown = self._cache_hbm_parts()
        return {"by_bucket": by_bucket, "total_bytes": total, "unknown_rows": unknown,
                "hbm_capacity_bytes": hbm_capacity(self._device_kind)}

    def _refresh_cache_hbm(self) -> None:
        by_bucket, total, _ = self._cache_hbm_parts()
        with self._hbm_lock:
            stale = self._hbm_buckets - set(by_bucket)
            self._hbm_buckets = set(by_bucket)
        help_ = "summed peak device memory of cached programs by shape bucket"
        for bucket in stale:
            self.registry.gauge("raft_cache_hbm_bytes", help_, bucket=bucket).set(0.0)
        for bucket, v in by_bucket.items():
            self.registry.gauge("raft_cache_hbm_bytes", help_, bucket=bucket).set(v)
        self.registry.gauge("raft_cache_hbm_total_bytes",
                            "summed peak device memory of every cached program").set(total)

    def attribution(self, peaks=None) -> Dict:
        """Per-program-kind MFU (the ledger joined with the registry)."""
        doc = self.ledger.attribution(self.registry, device_kind=self._device_kind,
                                      peaks=peaks)
        for kind, a in doc.items():
            if a["mfu"] is not None:
                self.registry.gauge("raft_program_mfu",
                                    "model flops utilization by program kind",
                                    kind=kind).set(a["mfu"])
        return doc

    def ledger_doc(self) -> Dict:
        with self._cache_lock:
            keys = list(self._cache)
        return self.ledger.to_doc(cache_keys=keys, backend=self._backend,
                                  device_kind=self._device_kind,
                                  attribution=self.attribution(), cache_hbm=self.cache_hbm())

    def capacity_status(self) -> Dict:
        """Per-bucket theoretical requests/s from the warmed EMA cost table
        (current fingerprint, canonical iterations only) and the device
        saturation from the tick deck."""
        from raft_stereo_tpu_torch.obs import capacity as cap
        with self._est_lock:
            ests = dict(self._estimates)
        fp = self._fingerprint()
        m_iters = self.cfg.valid_iters // self.cfg.segments
        kind_iters = {"full": self.cfg.valid_iters, "prepare": 0, "prepare_warm": 0,
                      "segment": m_iters, "advance": m_iters, "epilogue": 0}
        rows = [{"kind": k[0], "b": k[1], "h": k[2], "w": k[3], "iters": k[4], "est": v}
                for k, v in ests.items() if k[5] == fp and kind_iters.get(k[0]) == k[4]]
        doc = cap.model(rows, segments=self.cfg.segments, valid_iters=self.cfg.valid_iters)
        sat = cap.saturation(self.deck.snapshot(), now=self.clock.now(),
                             window_s=self._capacity_window_s)
        doc["saturation"] = sat
        ratio = sat["ratio"] if sat is not None else None
        for m in doc["by_bucket"].values():
            if m.get("rps") is not None:
                m["headroom_rps"] = m["rps"] * max(0.0, 1.0 - (ratio or 0.0))
        return doc

    # -- reporting --------------------------------------------------------

    def count_request(self, ok: bool, degraded: bool = False,
                      nonfinite: bool = False) -> None:
        """Count one request the scheduler served (it resolves its own
        responses), so the session counters are one truth in both modes."""
        if ok:
            self._ctr["requests_ok"].inc()
            if degraded:
                self._ctr["degraded"].inc()
        else:
            self._ctr["requests_failed"].inc()
            if nonfinite:
                self._ctr["nonfinite_outputs"].inc()

    def metrics(self) -> Dict:
        """The short-name counter dict, read off the registry."""
        return {k: int(c.value) for k, c in self._ctr.items()}

    def config_doc(self) -> Dict:
        """The resolved knob snapshot, fingerprint, breaker trips and
        program-cache contents."""
        env = self._resolve(self._env)
        return {
            "fingerprint": self.fingerprint_id(),
            "backend": self._backend,
            "device_kind": self._device_kind,
            "session_cfg": dataclasses.asdict(self.cfg),
            "env_knobs": {k: env.get(k) for k in sorted(env)},
            "breaker": self.breaker.status(),
            "batch_buckets": list(self._batch_buckets),
            "max_programs": self._max_programs,
            "programs": self.programs(),
            "deck": self.deck.status(),
            "capacity_window_s": self._capacity_window_s,
        }

    def programs(self) -> list:
        """One row per cached program: whether it has run, and on the card
        its graph's launches, capture seconds and pool bytes."""
        with self._cache_lock:
            progs = list(self._cache.values())
        return [{"id": p.ledger_id, "warmed": p.warmed, "graph": p.graph is not None,
                 "launches": dict(p.launches), "capture_s": p.capture_s,
                 "pool_bytes": p.pool_bytes} for p in progs]

    def status(self) -> Dict:
        with self._cache_lock:
            cached = [f"{k[0]}@b{k[1]}:{k[2]}x{k[3]}/it{k[4]}" for k in self._cache]
        counts = self.metrics()
        return {
            "device": str(self.device),
            "device_kind": self._device_kind,
            "graphs": self._graphs,
            "bucket": self.cfg.bucket,
            "valid_iters": self.cfg.valid_iters,
            "segments": self.cfg.segments,
            "max_batch": self.cfg.max_batch,
            "batch_buckets": list(self._batch_buckets),
            "fatal": None if self._fatal is None else self._fatal[0],
            "programs": {"cached": cached, "capacity": self._max_programs,
                         **{k: v for k, v in counts.items()
                            if k in ("compiles", "evictions")}},
            "breaker": self.breaker.status_with_heal(),
            "canary": dict(self._canary_state),
            "counts": {k: v for k, v in counts.items() if k not in ("compiles", "evictions")},
            "profiler": self.profiler.status(),
            "tracing": self.tracer.status(),
            "ledger": {"rows": len(self.ledger), "device_kind": self._device_kind,
                       "backend": self._backend, "cache_hbm": self.cache_hbm(),
                       "attribution": self.attribution()},
            "flight": self.flight.status(),
            "deck": self.deck.status(),
            "usage": self.usage.status(),
        }


@functools.lru_cache(maxsize=64)
def _twin_flops(kind: str, b: int, h: int, w: int, iters: int, cfg_items: tuple
                ) -> Optional[float]:
    """The flops of a program's fp32 ``reg`` twin on the meta device
    (``obs/ledger.py:program_twin``): the same for every correlation and
    precision of one architecture, so cached by geometry and config."""
    cfg = RAFTStereoConfig(**dict(cfg_items))
    return count_flops(program_twin(kind, cfg, b, h, w, iters))


def _view(model: RAFTStereo, cfg: RAFTStereoConfig) -> RAFTStereo:
    """``model`` with ``cfg`` as its config, sharing every parameter,
    buffer and cached kernel weight (the forward reads only ``model.cfg``)."""
    if cfg == model.cfg:
        return model
    view = object.__new__(type(model))
    view.__dict__ = dict(model.__dict__, cfg=cfg)
    return view
