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
on the card. Evicting a program frees its graph and pool. A capture runs
alone on its device and calls share it (``_CaptureGate``, one a device): a
capture fails on an allocation or a synchronizing copy on its device. It
runs in CUDA's thread-local mode, so work on other devices goes on beside
it, and it waits for its device at most ``GATE_WAIT_S``: a replay that
never comes back (a hung device) holds up that device and no other.

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
in one launch each.

**Pod serving** (``mesh_data`` n > 1, the JAX package's data mesh): one
session drives an ordered list of n devices (``cuda:0 .. cuda:n-1`` by
default, the CPU n times with ``device="cpu"``, or the ``mesh_devices`` the
caller passes), with one scheduler, one response cache and one ingress
above them. Batch buckets round up to multiples of n. A batched program at
bucket b is n shard programs of b/n rows, shard i on device i with that
device's weight replica: on the card each shard is its own CUDA graph
(captured under its device's gate), the host replays every shard before it
waits on any, and the carries stay on their shard's device between ticks
(``models/raft_stereo.py:ShardedCarry``); a row that changes shard is
copied device to device. The mesh extent and an epoch ride the cache key as
a trailing ``("mesh", n, epoch)``, never the fingerprint, so the response
cache stays one cache. A hung device is probed (``probe_chips``) and
quarantined: the mesh shrinks to the largest divisor of n that fits the
survivors and the epoch re-keys the programs; the recovery plane probes it
again on its backoff and re-admits it (``heal_mesh``), re-capturing the new
epoch's programs before it returns.

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
    RAFTStereo, ShardedCarry, _map_carry, gather_rows, raft_stereo_epilogue,
    raft_stereo_forward, raft_stereo_prepare, raft_stereo_segment,
    raft_stereo_segment_carry, shard_rows, stack_refinement_states)
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
from raft_stereo_tpu_torch.serve.supervise import InvocationWatch, _parse_number
from raft_stereo_tpu_torch.serve.validate import AdmissionConfig, validate_pair

logger = logging.getLogger(__name__)

# A program's Python reads the kernel switches from the process environment,
# so the windows in which one runs with its switch set exported (a capture on
# the card, every call on the CPU) are serialized across all programs.
_ENV_LOCK = threading.Lock()


class GateTimeout(TimeoutError):
    """A capture or a graph's release did not get its device alone in
    time: a call on that device has not come back (a hung device)."""


class _CaptureGate:
    """One device's programs: any number of calls copy in, replay and copy
    out at once; a capture, or a graph's release, runs alone. A capture
    fails on an allocation or a synchronizing copy on its own device (a
    replay's copy in or out) made while it runs. A waiting capture goes
    before new calls; it waits at most ``timeout`` seconds, then raises
    :class:`GateTimeout` and lets them in again, so a call that never comes
    back (a replay on a hung device) holds up that device alone."""

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
    def alone(self, timeout: Optional[float] = None):
        with self._cond:
            self._waiting += 1
            try:
                if not self._cond.wait_for(lambda: not (self._alone or self._shared),
                                           timeout=timeout):
                    raise GateTimeout(f"device busy past {timeout} s: a call on it has "
                                      "not come back")
            finally:
                self._waiting -= 1
                self._cond.notify_all()
            self._alone = True
        try:
            yield
        finally:
            with self._cond:
                self._alone = False
                self._cond.notify_all()


# One gate a device, process-wide (every session's programs on a device
# share its gate); captures run in CUDA's thread-local mode, so work on
# another device never invalidates one. Two chips of a mesh that list one
# device share its gate.
_GATES: Dict[str, _CaptureGate] = {}
_GATES_LOCK = threading.Lock()

# How long a capture or a release waits for its device: far past a
# replay's time, so only a call that never comes back makes it give up.
GATE_WAIT_S = 30.0


def _device_key(dev) -> str:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _gate(dev) -> _CaptureGate:
    with _GATES_LOCK:
        return _GATES.setdefault(_device_key(dev), _CaptureGate())


@contextlib.contextmanager
def _held(lock):
    """``lock`` held, or :class:`GateTimeout` after ``GATE_WAIT_S``: a
    capture that holds it past that is stuck on a hung device."""
    if not lock.acquire(timeout=GATE_WAIT_S):
        raise GateTimeout(f"a capture held the switch lock past {GATE_WAIT_S} s")
    try:
        yield
    finally:
        lock.release()


def _gates_of(devices) -> Tuple[_CaptureGate, ...]:
    """The distinct gates of ``devices`` in one fixed order: taken in it,
    two threads never each hold a gate the other waits for."""
    return tuple(_gate(k) for k in sorted({_device_key(d) for d in devices}))


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


# The data-mesh extent is resolved once a session and keys the programs as a
# trailing cache-key component, like the batch bucket; ``fingerprint_id()``
# stays mesh-independent so the response cache stays one cache above every
# device.

def resolve_serve_mesh_data(value: Optional[int] = None) -> int:
    """The data-mesh extent (devices one session drives): an explicit value
    wins, else ``RAFT_SERVE_MESH_DATA``, else 1 (one device, the keys
    without a mesh component)."""
    if value is not None:
        n = int(value)
    else:
        raw = os.environ.get("RAFT_SERVE_MESH_DATA", "").strip()
        if not raw:
            return 1
        n = _parse_number("RAFT_SERVE_MESH_DATA", raw, int)
    if n < 1:
        raise ValueError(f"RAFT_SERVE_MESH_DATA must be >= 1, got {n}")
    return n


def resolve_mesh_fallback() -> bool:
    """The mesh kill switch: ``RAFT_SERVE_MESH_FALLBACK=1`` forces one
    device whatever the config or environment asks. Host-side: it selects
    whether mesh programs exist, never what one program computes."""
    raw = os.environ.get("RAFT_SERVE_MESH_FALLBACK", "").strip()
    return raw not in ("", "0", "false", "False")


def _device_list(device: torch.device, n: int, devices=None) -> list:
    """The mesh's ordered devices: ``devices`` when given (its first n),
    else the CPU n times for a CPU session, else ``cuda:0 .. cuda:n-1``.
    Raises, naming the count, where fewer than n are there, and where a
    given device is not of the session's type."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        where = "given"
        other = sorted({str(d) for d in devs if d.type != device.type})
        if other:
            raise ValueError(f"mesh_devices {other} are not {device.type} devices like the "
                             "session's")
    elif device.type == "cpu":
        devs = [device] * n
        where = "cpu"
    else:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        where = "cuda"
    if n > len(devs):
        raise ValueError(f"mesh_data {n} exceeds the {len(devs)} available {where} "
                         "device(s)")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs[:n]]


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
    mesh_data: devices the session drives over its data mesh (None:
        ``RAFT_SERVE_MESH_DATA``, else 1). Above 1 the batch buckets round
        up to multiples of it and every batched program runs as that many
        shards, one a device.
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
        if self.mesh_data is not None and self.mesh_data < 1:
            raise ValueError(f"mesh_data must be >= 1, got {self.mesh_data}")
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
_WEIGHT_FREE = ("corr_implementation", "mixed_precision", "slow_fast_gru", "fused_update")

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


def _join_shards(outs: list, sharded: bool) -> tuple:
    """One call's fetched outputs from its parts' (in part order): a
    program off the mesh's as they are; a mesh program's carries as a
    :class:`ShardedCarry`, host rows concatenated, a host scalar (a
    checksum) summed."""
    if not sharded:
        return outs[0]
    joined = []
    for parts in zip(*outs):
        if isinstance(parts[0], dict):
            joined.append(ShardedCarry(parts))
        elif np.ndim(parts[0]) == 0:
            joined.append(np.asarray(sum(parts), dtype=np.asarray(parts[0]).dtype))
        else:
            joined.append(np.concatenate(parts, axis=0))
    return tuple(joined)


def _sum_counts(dicts) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for d in dicts:
        for k, n in d.items():
            out[k] = out.get(k, 0) + n
    return out


class _Program:
    """One cached program and its lock. ``env`` is the switch set its
    Python runs under. On the card, ``graph`` is its CUDA graph once
    captured, with its static buffers, the launches each kernel wrapper made
    while it was captured (a replay makes the same launches and counts
    none), and the capture's seconds and pool bytes.

    A data-mesh program (``mesh``: the key's ``("mesh", n, epoch)``) runs
    as ``shards``: n programs of b/n rows, shard i on ``device`` of mesh
    chip ``chip``, each with its own graph and buffers."""

    __slots__ = ("key", "fn", "kind", "env", "warmed", "lock", "ledger_id", "graph",
                 "static_in", "static_out", "launches", "variants", "capture_s",
                 "pool_bytes", "mesh", "shards", "device", "chip")

    def __init__(self, key, fn, kind, env, device=None, shards=None, chip=None):
        self.key = key
        self.fn = fn
        self.kind = kind
        self.env = dict(env)
        self.mesh = key[6] if len(key) > 6 else None
        self.shards = shards
        self.device = device
        self.chip = chip
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
        """Free the graph and its pool (each shard's); a later call
        captures again. A program whose call has not come back (a replay on
        a hung device) keeps its graph: freeing it would wait on that
        device for good."""
        if not self.lock.acquire(timeout=GATE_WAIT_S):
            logger.error("program %s: a call has not come back; its graphs are left "
                         "unfreed", self.ledger_id)
            return
        try:
            for part in self.shards or (self,):
                if part.graph is not None:
                    try:
                        with _gate(part.device).alone(timeout=GATE_WAIT_S):
                            part.graph.reset()
                    except GateTimeout:
                        logger.error("program %s: %s busy; its graph is left unfreed",
                                     self.ledger_id, part.device)
                        continue
                part.graph = part.static_in = part.static_out = None
            self.warmed = False
        finally:
            self.lock.release()

    @property
    def captured(self) -> bool:
        return all(p.graph is not None for p in self.shards or (self,))

    def captured_launches(self) -> Dict[str, int]:
        """The launches captured in this program: a mesh program's are its
        shards' together."""
        return _sum_counts(p.launches for p in self.shards or (self,))


class InferenceSession:
    """Owns a model and its config; admits arbitrary pairs, serves
    disparity.

    ``model`` is a :class:`RAFTStereo` (its weights; the session moves it to
    ``device``); ``cfg`` is the configuration to serve, of the model's
    architecture (the correlation, the precision and ``slow_fast_gru`` may
    differ from the model's own). ``device=None`` is the card
    (``resolve_device``), which raises where there is none: the session
    never falls back to the CPU. ``mesh_devices`` lists the data mesh's
    devices in order (its first ``mesh_data``; a device may be listed more
    than once); by default they are ``cuda:0 ..`` on the card, the CPU
    repeated on the CPU.
    """

    def __init__(self, model: RAFTStereo, cfg: RAFTStereoConfig,
                 session_cfg: Optional[SessionConfig] = None, *, device=None,
                 mesh_devices=None,
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
        # The data mesh: the base extent is resolved once (kill switch >
        # SessionConfig > RAFT_SERVE_MESH_DATA > 1). ``_mesh_live`` holds
        # the live chips (indices into ``_mesh_devices``, the pod), None
        # with no mesh; a quarantine or a re-admission bumps the epoch,
        # which re-keys the mesh programs, and ``_mesh_epochs`` keeps each
        # epoch's chips for the programs keyed under it.
        self._mesh_lock = threading.RLock()
        self._mesh_devices: list = []
        self._mesh_live: Optional[Tuple[int, ...]] = None
        self._mesh_n = 1
        self._mesh_epoch = 0
        self._mesh_epochs: Dict[int, Tuple[int, ...]] = {}
        self._quarantined: set = set()
        self._replicas: Dict[str, RAFTStereo] = {}
        self._streams: Dict[str, "torch.cuda.Stream"] = {}
        # Per-chip probation (backoff, deadline, probes, re-admission
        # times, permanent) and the last recovery's MTTR.
        self._chip_heal: Dict[int, Dict] = {}
        self._heal_mttr: Dict = {"last_s": None, "events": 0}
        self._mesh_base_n = (1 if resolve_mesh_fallback()
                             else resolve_serve_mesh_data(self.cfg.mesh_data))
        if mesh_devices is not None and self._mesh_base_n == 1:
            raise ValueError("mesh_devices is given but the session has no data mesh "
                             "(mesh_data 1)")
        if self._mesh_base_n > 1:
            self._mesh_devices = _device_list(self.device, self._mesh_base_n, mesh_devices)
        # Device work outside a program takes the gates of the devices it
        # touches (on the card; ``device_ops``).
        self._gated = self._graphs
        self._pod_gates = _gates_of([self.device, *self._mesh_devices])
        if self._mesh_base_n > 1:
            self._build_mesh(tuple(range(self._mesh_base_n)))
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
        buckets = capped + (covering,)
        if self._mesh_n > 1:
            # Every bucket rounds up to a multiple of the mesh extent, so a
            # batch always splits evenly over the shards; the extra rows are
            # pad rows (the scheduler's pad_rows), never occupancy.
            n = self._mesh_n
            buckets = tuple(sorted({-(-b // n) * n for b in buckets}))
        return buckets

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

    # -- pod mesh ---------------------------------------------------------

    def _replica(self, dev: torch.device) -> RAFTStereo:
        """The weights on ``dev``: the session's model on its own device, a
        copy made once on any other (a device listed twice shares one)."""
        key = str(dev)
        with self._mesh_lock:
            model = self._replicas.get(key)
            if model is None:
                if dev == next(self._model.parameters()).device:
                    model = self._model
                else:
                    model = RAFTStereo(self._model.cfg)
                    with self.device_ops():  # copies from the card
                        model.load_state_dict(self._model.state_dict())
                    model = model.to(dev).eval()
                self._replicas[key] = model
            return model

    def _build_mesh(self, chips: Tuple[int, ...]) -> None:
        """(Re)build the live mesh over ``chips`` (indices into the pod) for
        the current epoch: each live device gets its weight replica for
        the epoch (and on the card its capture stream), and the epoch's
        chips are kept for its programs. At construction this covers every
        device of the pod, so a later call makes nothing new."""
        with self._mesh_lock:  # reentrant from quarantine_chip / readmit_chip
            for c in chips:
                dev = self._mesh_devices[c]
                self._replica(dev)
                if self._graphs and str(dev) not in self._streams:
                    self._streams[str(dev)] = torch.cuda.Stream(dev)
            self._mesh_live = tuple(chips)
            self._mesh_n = len(chips)
            self._mesh_epochs[self._mesh_epoch] = self._mesh_live

    @property
    def mesh_active(self) -> bool:
        return self._mesh_live is not None

    @property
    def mesh_chips(self) -> int:
        """Chips the live mesh spans (1: single-device serving)."""
        return self._mesh_n if self._mesh_live is not None else 1

    def _probe(self, chips, timeout_s: float, name: str) -> Tuple[int, ...]:
        """Probe ``chips`` on a daemon thread each: a scalar to the device
        and back (the host copy is the completion barrier), sharing that
        device's gate (:meth:`device_ops`). A probe that raises or
        has not finished within ``timeout_s`` is a hung chip; one still
        waiting for its gate then is behind a capture on that device, and
        gets ``timeout_s`` from when the capture lets it in (at most
        ``GATE_WAIT_S`` later). The ``faults.on_chip_probe`` hook runs
        inside each probe thread, so a fault plan can park exactly one
        chip's probe."""
        done: Dict[int, bool] = {}
        queued = {i: threading.Event() for i in chips}
        entered = {i: threading.Event() for i in chips}

        def _run(i: int) -> None:
            try:
                self.faults.on_chip_probe(i)
                dev = self._mesh_devices[i]
                queued[i].set()
                with self.device_ops([dev]):
                    entered[i].set()
                    torch.zeros((), device=dev).cpu()
                done[i] = True
            except Exception:  # noqa: BLE001 — a failed probe is a hung chip
                done[i] = False

        threads = []
        for i in chips:
            t = threading.Thread(target=_run, args=(i,), name=f"{name}-{i}", daemon=True)
            t.start()
            threads.append((i, t))
        deadline = self.clock.now() + timeout_s
        for _, t in threads:
            # graftlint: disable=GC203 (deadline-capped probe join on the serialized bounce path)
            t.join(timeout=max(0.05, deadline - self.clock.now()))
        for i, t in threads:
            if t.is_alive() and queued[i].is_set() and not entered[i].is_set():
                if entered[i].wait(GATE_WAIT_S):
                    # graftlint: disable=GC203 (deadline-capped probe join on the serialized bounce path)
                    t.join(timeout=timeout_s)
        return tuple(i for i, t in threads if t.is_alive() or not done.get(i, False))

    def probe_chips(self, timeout_s: float = 2.0) -> Tuple[int, ...]:
        """Probe every chip of the pod that is not quarantined; returns the
        hung chips (indices into the pod's device list)."""
        if not self._mesh_devices:
            return ()
        with self._mesh_lock:
            chips = [i for i in range(len(self._mesh_devices)) if i not in self._quarantined]
        return self._probe(chips, timeout_s, "chip-probe")

    def _regrow_extent(self) -> int:
        """Rebuild the mesh over the healthy chips at the largest divisor of
        the base extent that fits them, under a new epoch. Returns the new
        extent. Takes the mesh lock (re-entrant: its callers hold it)."""
        with self._mesh_lock:
            healthy = tuple(i for i in range(len(self._mesh_devices))
                            if i not in self._quarantined)
            self._mesh_epoch += 1
            if not healthy:
                # Every chip gone: serving fails downstream, never on a
                # quarantined chip by stealth.
                self._mesh_live = None
                self._mesh_n = 1
                return 0
            # The largest divisor of the base extent that fits: it divides
            # every rounded batch bucket.
            base = self._mesh_base_n
            n = max(d for d in range(1, base + 1) if base % d == 0 and d <= len(healthy))
            self._build_mesh(healthy[:n])
        self.registry.gauge("raft_mesh_chips", "chips the live data mesh spans").set(n)
        return n

    def _chip_backoff(self, st: Dict, now: float) -> None:
        """Double a chip's probation backoff (to its cap) and set its next
        probe one backoff from ``now``."""
        st["backoff_s"] = min(st["backoff_s"] * 2.0, self._heal_backoff_max_s)
        st["deadline"] = now + st["backoff_s"]

    def _flap_window(self, chip: int, st: Dict, now: float) -> list:
        """The chip's re-admissions within the flap window. At the flap cap
        the chip is out for good (logged and counted once)."""
        window = [t for t in st["readmitted"] if now - t <= self._heal_window_s]
        if len(window) >= self._heal_flap_cap and not st["permanent"]:
            st["permanent"] = True
            logger.error("chip %d: %d re-admissions in the flap window: permanently out",
                         chip, len(window))
            self.registry.counter("raft_heal_chips_permanent_total",
                                  "chips permanently quarantined by the flap cap").inc()
        return window

    def quarantine_chip(self, chip: int) -> bool:
        """Take one hung chip out of the live mesh: shrink to the largest
        divisor of the base extent that fits the survivors and bump the
        epoch, re-keying the mesh programs. False when the chip is already
        quarantined or out of range."""
        with self._mesh_lock:
            if chip in self._quarantined or not 0 <= chip < len(self._mesh_devices):
                return False
            self._quarantined.add(chip)
            if self._heal_enabled:
                # Arm (or re-arm) the chip's probation. A re-quarantine
                # doubles the backoff and counts against the flap cap: a chip
                # flapping past it within the window is out for good.
                now = self.clock.now()
                st = self._chip_heal.get(chip)
                if st is None:
                    self._chip_heal[chip] = {
                        "backoff_s": self._heal_backoff_s,
                        "deadline": now + self._heal_backoff_s, "probes": 0,
                        "readmitted": [], "permanent": False, "quarantined_at": now}
                else:
                    st["quarantined_at"] = now
                    self._chip_backoff(st, now)
                    self._flap_window(chip, st, now)
            n = self._regrow_extent()
            if n == 0:
                logger.error("all %d mesh chips quarantined", len(self._mesh_devices))
                return True
            logger.warning("quarantined chip %d; mesh now %d chip(s) (epoch %d, "
                           "quarantined=%s)", chip, n, self._mesh_epoch,
                           sorted(self._quarantined))
            self.registry.counter("raft_mesh_chips_quarantined_total",
                                  "chips removed from the live data mesh").inc()
            return True

    def mesh_status(self) -> Dict:
        """The /healthz and /debug/config ``mesh`` block (one row a chip of
        the pod)."""
        with self._mesh_lock:
            return {
                "enabled": self._mesh_live is not None,
                "n_data": self.mesh_chips,
                "base_n_data": self._mesh_base_n,
                "epoch": self._mesh_epoch,
                "live": list(self._mesh_live or ()),
                "quarantined": sorted(self._quarantined),
                "devices": [{"chip": i, "device": str(d),
                             "kind": (torch.cuda.get_device_name(d) if d.type == "cuda"
                                      else None),
                             "quarantined": i in self._quarantined}
                            for i, d in enumerate(self._mesh_devices)],
            }

    # -- recovery plane (chips) -------------------------------------------

    def probe_quarantined(self, chips: Tuple[int, ...],
                          timeout_s: float = 2.0) -> Tuple[int, ...]:
        """Probe exactly the given quarantined chips (the ``probe_chips``
        recipe) and return those that failed."""
        chips = [i for i in chips if 0 <= i < len(self._mesh_devices)]
        return self._probe(chips, timeout_s, "chip-heal-probe")

    def readmit_chip(self, chip: int) -> bool:
        """Re-grow the mesh onto one probe-verified chip: flap-cap check,
        un-quarantine, the extent recomputed, the epoch bumped; then the new
        epoch's programs are warmed (captured on the card) before this
        returns, so no request meets a cold program on the grown mesh.
        False when the chip is not quarantined, healing is off or the flap
        cap fired."""
        with self._mesh_lock:
            if not self._heal_enabled or chip not in self._quarantined:
                return False
            st = self._chip_heal.get(chip)
            now = self.clock.now()
            if st is None or st["permanent"]:
                return False
            window = self._flap_window(chip, st, now)
            if st["permanent"]:
                return False
            self._quarantined.discard(chip)
            st["readmitted"] = window + [now]
            # A later quarantine starts again at the base backoff.
            st["backoff_s"] = self._heal_backoff_s
            n = self._regrow_extent()
            logger.warning("re-admitted chip %d; mesh now %d chip(s) (epoch %d, "
                           "quarantined=%s)", chip, n, self._mesh_epoch,
                           sorted(self._quarantined))
            self.registry.counter("raft_heal_chips_readmitted_total",
                                  "chips re-admitted to the live data mesh").inc()
            mttr = now - st["quarantined_at"]
            self._heal_mttr = {"last_s": mttr, "events": self._heal_mttr["events"] + 1}
            self.registry.gauge("raft_heal_mttr_seconds",
                                "last fault-injected -> capacity-restored interval "
                                "(session clock)").set(mttr)
        # Outside the mesh lock (captures are slow; a quarantine from
        # another thread must not wait behind them), before returning.
        if self.cfg.max_batch > 1:
            for (h, w) in self.cfg.warmup_shapes:
                self._warm_shape(h, w)
        return True

    def heal_mesh(self, probe_timeout_s: float = 2.0) -> Dict:
        """One recovery sweep over the quarantined chips: probe each whose
        probation deadline passed, re-admit those that pass, double the
        backoff of those that fail. Returns ``{"probed", "readmitted",
        "failed"}`` chip lists."""
        out: Dict = {"probed": [], "readmitted": [], "failed": []}
        if not self._heal_enabled or self._heal_flap_cap < 1:
            return out
        now = self.clock.now()
        with self._mesh_lock:
            candidates = []
            for c in sorted(self._quarantined):
                st = self._chip_heal.get(c)
                if st is None or st["permanent"] or now < st["deadline"]:
                    continue
                # Handing it out pushes the deadline one backoff on, so a
                # concurrent sweep cannot probe it twice.
                st["probes"] += 1
                st["deadline"] = now + st["backoff_s"]
                candidates.append(c)
        if not candidates:
            return out
        out["probed"] = list(candidates)
        failed = set(self.probe_quarantined(tuple(candidates), timeout_s=probe_timeout_s))
        for c in candidates:
            ok = c not in failed and self.readmit_chip(c)
            self.registry.counter("raft_heal_chip_probes_total",
                                  "quarantined-chip probation probes by outcome",
                                  result=("passed" if ok else "failed")).inc()
            if ok:
                out["readmitted"].append(c)
                continue
            out["failed"].append(c)
            if c in failed:
                with self._mesh_lock:
                    st = self._chip_heal.get(c)
                    if st is not None:
                        self._chip_backoff(st, self.clock.now())
        return out

    @contextlib.contextmanager
    def device_ops(self, devices=None):
        """Around device work done outside a program (the scheduler's row
        gathers and joins, the uploader's copies, a probe): on the card it
        shares each device it touches (``devices``; by default the
        session's and every device of the pod) with replays and waits out a
        capture there (``_CaptureGate``), which an allocation or a
        synchronizing copy on that device would invalidate. Never hold it
        across :meth:`invoke`."""
        if not self._gated:
            yield
            return
        gates = self._pod_gates if devices is None else _gates_of(devices)
        with contextlib.ExitStack() as stack:
            for g in gates:
                stack.enter_context(g.shared())
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
        key = (kind, b, h, w, iters, self._fingerprint(cfg, env))
        with self._mesh_lock:
            live, n, epoch = self._mesh_live, self._mesh_n, self._mesh_epoch
        if live is not None and b % n == 0:
            # The mesh changes the program (n shards), so it re-keys: as a
            # trailing component, only on a live mesh and a bucket that
            # splits evenly, so keys off the mesh stay as they were and
            # key[:6] means what it always meant. The epoch keeps a shrunk
            # or re-grown mesh from being served another epoch's program.
            key = key + (("mesh", n, epoch),)
        return key

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
                prog = self._build(key, kind, cfg, iters, run_env)
            except Exception as e:
                setattr(e, "_raft_phase", "compile_failure")
                with self._cache_lock:
                    self._key_locks.pop(key, None)
                raise
            self._ctr["compiles"].inc()
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

    def _build(self, key: Tuple, kind: str, cfg, iters: int, run_env) -> _Program:
        """A program for ``key``: on the session's device, or for a mesh key
        one shard a live chip of its epoch, each on that device's replica."""
        if len(key) <= 6:
            return _Program(key, build_program(kind, _view(self._model, cfg), iters), kind,
                            run_env, device=self.device)
        with self._mesh_lock:
            chips = self._mesh_epochs[key[6][2]]
        shards = tuple(
            _Program(key, build_program(kind, _view(self._replica(self._mesh_devices[c]), cfg),
                                        iters), kind, run_env,
                     device=self._mesh_devices[c], chip=c)
            for c in chips)
        return _Program(key, None, kind, run_env, shards=shards)

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

    def _capture(self, prog: _Program, args) -> Dict:
        """Build ``prog``'s CUDA graph (a shard's, for a mesh program) with
        ``args`` as its first inputs: static buffers on its device, a
        warm-up on the device's side stream, the capture on the same
        stream, in CUDA's thread-local mode (work on another device goes on
        beside it). Returns the ledger's numbers. Called under the
        program's lock, ``_ENV_LOCK`` with the program's switches exported,
        and its device's gate alone."""
        dev = prog.device
        stream = self._stream if dev == self.device else self._streams[str(dev)]
        with torch.cuda.device(dev):
            # graftlint: disable=GC203 (capture precondition, once a program: the card idle)
            torch.cuda.synchronize(dev)
            start = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            prog.static_in = tuple(_static_like(a, dev) for a in args)
            prog.copy_in(args)
            arg_bytes = float(sum(_nbytes(a) for a in args))
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                prog.fn(*prog.static_in)  # warm-up: kernels built, attributes set
            # graftlint: disable=GC203 (capture precondition, once a program: warm-up done)
            torch.cuda.synchronize(dev)
            # torch.cuda.graph empties the allocator's cache as it opens;
            # done here first, the reserved bytes it adds are the graph's
            # pool alone.
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            launches, variants = dict(kernels.launches), dict(kernels.variants)
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
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
        return {"argument_bytes": arg_bytes, "temp_bytes": max(peak - arg_bytes, 0.0),
                "capture_s": prog.capture_s, "graph_pool_bytes": prog.pool_bytes}

    def _shard_args(self, prog: _Program, args) -> list:
        """A program's arguments, one tuple a part. Off the mesh: ``[args]``,
        a sharded carry's rows gathered onto the program's device (a mesh
        program's carry meeting a program off the mesh: every chip
        quarantined). A mesh program's shard i takes rows ``[i*k,
        (i+1)*k)`` (k = b/n) on its device: host arrays are split (each
        shard's copy in uploads its rows); a device tensor's rows and a
        carry's are copied device to device where they are not already on
        the shard's device, and a carry that is already in the shard layout
        (the previous call's output) is passed as it is."""
        if prog.shards is None:
            return [tuple(gather_rows(a, prog.device) if isinstance(a, ShardedCarry) else a
                          for a in args)]
        devices = [s.device for s in prog.shards]
        k = prog.key[1] // len(devices)
        per_arg = []
        for a in args:
            if isinstance(a, np.ndarray):
                per_arg.append([a[i * k:(i + 1) * k] for i in range(len(devices))])
            elif isinstance(a, torch.Tensor):
                per_arg.append([a[i * k:(i + 1) * k].to(d, non_blocking=True)
                                for i, d in enumerate(devices)])
            else:
                per_arg.append(shard_rows(a, devices, k))
        return [tuple(p[i] for p in per_arg) for i in range(len(devices))]

    def _run(self, prog: _Program, args) -> Tuple[tuple, float]:
        """One call of ``prog``: (outputs, the session-clock time its inputs
        were in and its work dispatched). A mesh program runs as its shards
        (a program off the mesh as itself): every part's copy in and replay
        (eager on the CPU) is issued before any part's outputs are fetched,
        and the outputs are joined in part order. Each part holds its
        device's gate only for its own copy in and replay and for its own
        copy out, so a call that never comes back holds up one device."""
        parts = prog.shards or (prog,)
        with self.device_ops():
            part_args = self._shard_args(prog, args)
        sharded = prog.shards is not None
        if not self._graphs:
            with prog.lock:
                if not prog.warmed:
                    self._record(prog, {"flops": self._twin_flops(prog)})
                with _ENV_LOCK, _env_overrides(prog.env):
                    raws = [p.fn(*[_as_input(a) for a in pa])
                            for p, pa in zip(parts, part_args)]
                    t_disp = self.clock.now()
                prog.warmed = True
            return _join_shards([_fetch(r, clone=False) for r in raws], sharded), t_disp
        with prog.lock:
            fresh = [i for i, p in enumerate(parts) if p.graph is None]
            if fresh:
                stats = []
                try:
                    with _held(_ENV_LOCK), _env_overrides(prog.env):
                        for i in fresh:
                            with _gate(parts[i].device).alone(timeout=GATE_WAIT_S):
                                stats.append(self._capture(parts[i], part_args[i]))
                except GateTimeout as e:
                    setattr(e, "_raft_phase", CAPTURE_PHASE)
                    raise
                self._record(prog, {"flops": self._twin_flops(prog),
                                    **{k: sum(s[k] for s in stats) for k in stats[0]}})
            for i, (p, pa) in enumerate(zip(parts, part_args)):
                with _gate(p.device).shared(), torch.cuda.device(p.device):
                    if i not in fresh:
                        p.copy_in(pa)  # a capture copied its first inputs in
                    p.replay()
            t_disp = self.clock.now()
            outs = []
            for p in parts:
                with _gate(p.device).shared(), torch.cuda.device(p.device):
                    outs.append(p.copy_out())
            prog.warmed = True
        return _join_shards(outs, sharded), t_disp

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
        # The chips this call spanned, from the program's own key (a
        # quarantine since it was built does not relabel it); its device
        # seconds are one wall interval whatever the span.
        chips = prog.mesh[1] if prog.mesh is not None else 1
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
                t1=t_end, host_s=host_s, device_s=device_s, warming=False, chips=chips)
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
                t1=t_end, host_s=host_s, device_s=device_s, warming=True, chips=chips)
            trace.add_span(prog.kind, t0, t_end, warming=True, program=prog.ledger_id)
        if self.faults.poisoned(ordinal):
            flow_i = {"full": 0, "segment": 1, "epilogue": 0}.get(prog.kind)
            if flow_i is not None:
                out = out[:flow_i] + (poison_disparity(out[flow_i]),) + out[flow_i + 1:]
        return out

    def program_launches(self, kind: str, h: int, w: int, iters: int,
                         b: int = 1) -> Dict[str, int]:
        """The kernel launches captured in this program under the current
        run config (empty on the CPU, or before its first call); a mesh
        program's are its shards' together."""
        key = self.cache_key(kind, h, w, iters, b=b)
        with self._cache_lock:
            prog = self._cache.get(key)
        return prog.captured_launches() if prog is not None else {}

    def program_shards(self, kind: str, h: int, w: int, iters: int,
                       b: int = 1) -> list:
        """One row a shard of this program under the current run config:
        its chip, device, captured launches (and by variant), capture
        seconds and pool bytes (one row for a program off the mesh; empty
        when it is not cached)."""
        key = self.cache_key(kind, h, w, iters, b=b)
        with self._cache_lock:
            prog = self._cache.get(key)
        if prog is None:
            return []
        return [{"chip": p.chip, "device": str(p.device), "launches": dict(p.launches),
                 "variants": dict(p.variants), "capture_s": p.capture_s,
                 "pool_bytes": p.pool_bytes}
                for p in prog.shards or (prog,)]

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
                with self.device_ops([self.device]):  # copies from the card
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
        """The /healthz ``heal`` block: the pacing knobs, the breaker's
        per-rung and the mesh's per-chip probation state, the MTTR (one row
        a rung, one a chip of the pod)."""
        with self._mesh_lock:
            now = self.clock.now()
            chips = {}
            for chip, st in sorted(self._chip_heal.items()):
                quarantined = chip in self._quarantined
                chips[str(chip)] = {
                    "quarantined": quarantined,
                    "permanent": st["permanent"],
                    "backoff_ms": st["backoff_s"] * 1e3,
                    "probes": st["probes"],
                    "readmissions": len(st["readmitted"]),
                    "eligible_in_s": (max(0.0, st["deadline"] - now)
                                      if quarantined and not st["permanent"] else None),
                }
            mttr = dict(self._heal_mttr)
        return {
            "enabled": self._heal_enabled,
            "backoff_ms": self._heal_backoff_s * 1e3,
            "backoff_max_ms": self._heal_backoff_max_s * 1e3,
            "flap_cap": self._heal_flap_cap,
            "window_ms": self._heal_window_s * 1e3,
            "breaker": self.breaker.heal_status(),
            "chips": chips,
            "mttr": mttr,
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
        if self._mesh_base_n > 1:
            # Per chip: a mesh call's device window busies every chip it
            # spans at once; headroom divides by the live extent, and a
            # quarantined chip has none.
            mesh = self.mesh_status()
            per_chip = cap.saturation_per_chip(
                self.deck.snapshot(), len(self._mesh_devices), now=self.clock.now(),
                window_s=self._capacity_window_s)
            best = max((m.get("headroom_rps") or 0.0 for m in doc["by_bucket"].values()),
                       default=None)
            for row in per_chip:
                chip = row["chip"]
                row["quarantined"] = chip in mesh["quarantined"]
                with self._mesh_lock:
                    st = self._chip_heal.get(chip)
                    if row["quarantined"] and st is not None:
                        row["permanent"] = st["permanent"]
                row["headroom_rps"] = (0.0 if row["quarantined"] else None if best is None
                                       else best / max(1, self.mesh_chips))
                self.registry.gauge(
                    "raft_capacity_chip_saturation",
                    "device-busy fraction over the capacity window, per mesh chip",
                    chip=str(chip)).set(row["ratio"] if row["ratio"] is not None else 0.0)
            doc["chips"] = {"n_data": mesh["n_data"], "base_n_data": mesh["base_n_data"],
                            "quarantined": mesh["quarantined"], "per_chip": per_chip}
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
            "mesh": self.mesh_status(),
            "deck": self.deck.status(),
            "capacity_window_s": self._capacity_window_s,
        }

    def programs(self) -> list:
        """One row per cached program: whether it has run, and on the card
        its graph's launches, capture seconds and pool bytes (a mesh
        program's summed over its shards, with its ``mesh`` key part)."""
        with self._cache_lock:
            progs = list(self._cache.values())
        rows = []
        for p in progs:
            parts = p.shards or (p,)
            known = [q for q in parts if q.capture_s is not None]
            rows.append({"id": p.ledger_id, "warmed": p.warmed, "graph": p.captured,
                         "launches": p.captured_launches(),
                         "capture_s": sum(q.capture_s for q in known) if known else None,
                         "pool_bytes": (sum(q.pool_bytes for q in known) if known
                                        else None)})
            if p.mesh is not None:
                rows[-1]["mesh"] = list(p.mesh)
        return rows

    def status(self) -> Dict:
        with self._cache_lock:
            cached = [f"{k[0]}@b{k[1]}:{k[2]}x{k[3]}/it{k[4]}"
                      + (f"/mesh{k[6][1]}" if len(k) > 6 else "") for k in self._cache]
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
            "mesh": self.mesh_status(),
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
