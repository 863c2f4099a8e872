"""Long-lived stereo stream sessions: warm starts and the convergence exit.

The port's counterpart of the JAX package's ``serve/stream.py``, with the
same knobs, metrics, labels and request protocol.

- **warm-start sessions**: a client stamps consecutive frames with one
  ``X-Raft-Session`` header (wire) or ``request["stream"]`` (in-process);
  each served frame's 1/8-res disparity is held on the host in a bounded
  session table and seeds the next frame's ``coords1`` through the
  ``prepare_warm`` program (``serve/session.py:build_program``), a program
  kind of its own with its own cache key (a CUDA graph on the card). The
  seed is x only; the program makes the y channel as zeros, which keeps the
  ``flow_y == 0`` invariant the loop kernels' motion encoder relies on
  (it drops the flow-y weights), so warm carries ride the SAME ``advance``
  and ``epilogue`` programs as cold rows and share their device batches;

- **convergence early exit**: the ``advance`` program returns a per-row
  delta-flow norm (the segment mean of ``|delta_x|`` per iteration) beside
  its carry; at segment boundaries a row whose norm fell below the
  request's tolerance exits through the epilogue with the honest label
  ``converged:<iterations run>``. The tolerance is compared on the host:
  ``RAFT_CONVERGE_TOL`` never enters a program or the fingerprint;

- **bounded session table**: a global LRU cap (``RAFT_STREAM_SESSIONS``),
  a per-tenant cap, TTL expiry on the session clock
  (``RAFT_STREAM_TTL_MS``); session ids are sanitized as tenants are, so
  session-id churn cannot grow host memory or ``/metrics`` labels;
  sessions die on service stop and drain, and a deposit landing after its
  session expired is a counted drop, never a resurrection;

- **supervision**: the held ``flow_init`` rides the request dict, so a
  generation bounce harvests and re-admits warm rows with their seed.

One session holds one ``(1, H/8, W/8, 1)`` float32 field, ~196 KiB at
2016x2976, so the default 128-session cap bounds the table at ~25 MiB.
On a data mesh (``serve/session.py``, ``mesh_data`` > 1) a new session is
pinned round-robin to a shard (``_chip`` on its requests; the scheduler
keeps a chip's rows together). A device-hang bounce that quarantines a chip
moves the sessions pinned to it onto the survivors
(``migrate_off_chips``), parking them off the mesh when it shrinks to one
chip, and a re-grown mesh re-pins the parked ones (``repin_unplaced``);
the held seed is on the host, so a moved session stays warm.

The sequential (``max_batch == 1``) twin of the scheduler's warm path is
:func:`stream_infer`: prepare or prepare_warm, ``advance`` segments, then
``epilogue``, on the b=1 programs, with the same convergence and deadline
exits; the worker-pool service mode and ``demo --video`` run it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from raft_stereo_tpu_torch.obs.tracing import NULL_TRACE
from raft_stereo_tpu_torch.obs.usage import sanitize_tenant
from raft_stereo_tpu_torch.serve.degrade import SAFETY
from raft_stereo_tpu_torch.serve.session import InferenceFailed, InferenceResult
# One named-ValueError parser for env knobs, shared with the supervision and
# HTTP knob resolvers; the ``os.environ`` reads stay literal at each
# resolve_* site so the knob registry's cross-check sees them.
from raft_stereo_tpu_torch.serve.supervise import _parse_number

logger = logging.getLogger(__name__)

#: Bounded session table default: covers a realistic rig fleet while
#: bounding worst-case host memory at ~25 MiB of held flow fields.
DEFAULT_STREAM_SESSIONS = 128

#: Idle sessions expire after this long (session clock): a camera that
#: went away must not pin its slot until eviction pressure arrives.
DEFAULT_STREAM_TTL_MS = 60_000.0

#: Default convergence tolerance for warm frames: segment-mean
#: per-iteration |delta_x| at 1/8 res, in pixels. 0 disables the early
#: exit (the norm is >= 0, and the comparison is strict <).
DEFAULT_CONVERGE_TOL = 0.01


def resolve_stream_sessions(value: Optional[int] = None) -> int:
    """Effective global session-table cap: explicit config wins, else
    ``RAFT_STREAM_SESSIONS``, else 128. Host-side table sizing only."""
    if value is not None:
        return int(value)
    raw = os.environ.get("RAFT_STREAM_SESSIONS", "").strip()
    if not raw:
        return DEFAULT_STREAM_SESSIONS
    n = _parse_number("RAFT_STREAM_SESSIONS", raw, int)
    if n < 1:
        raise ValueError(f"RAFT_STREAM_SESSIONS must be >= 1, got {n}")
    return n


def resolve_stream_ttl_ms(value: Optional[float] = None) -> float:
    """Effective idle-session TTL in ms: explicit config wins, else
    ``RAFT_STREAM_TTL_MS``, else 60 s."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_STREAM_TTL_MS", "").strip()
    if not raw:
        return DEFAULT_STREAM_TTL_MS
    ttl = _parse_number("RAFT_STREAM_TTL_MS", raw, float)
    if ttl <= 0:
        raise ValueError(f"RAFT_STREAM_TTL_MS must be > 0, got {ttl}")
    return ttl


def resolve_converge_tol(value: Optional[float] = None) -> float:
    """Effective warm-frame convergence tolerance: explicit config wins,
    else ``RAFT_CONVERGE_TOL``, else 0.01 px/iter. A host-side comparison
    against the norm the advance program already returns, so it never
    changes a program and stays out of the fingerprint."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_CONVERGE_TOL", "").strip()
    if not raw:
        return DEFAULT_CONVERGE_TOL
    tol = _parse_number("RAFT_CONVERGE_TOL", raw, float)
    if tol < 0:
        raise ValueError(f"RAFT_CONVERGE_TOL must be >= 0, got {tol}")
    return tol


class StreamSession:
    """One live stream's host-side state. Mutated only under the manager's
    lock; the held flow array is immutable once deposited."""

    __slots__ = ("key", "tenant", "flow", "padded_shape", "frames",
                 "warm_frames", "created", "last_seen", "chip")

    def __init__(self, key: Tuple[str, str], now: float,
                 chip: Optional[int] = None):
        self.key = key
        self.tenant = key[0]
        self.flow: Optional[np.ndarray] = None   # (1, H/f, W/f, 1) fp32
        self.padded_shape: Optional[Tuple[int, int]] = None
        self.frames = 0
        self.warm_frames = 0
        self.created = now
        self.last_seen = now
        # The data shard a session is pinned to on a mesh; None on one
        # card, which is all the port's session drives.
        self.chip = chip


class StreamManager:
    """Bounded (LRU + TTL + per-tenant caps) session table and the request
    stamping and deposit protocol the service drives.

    Protocol (all on the request dict, so bounces and retries carry it):

    - :meth:`admit` (service admission): resolves the session for
      ``request["stream"]``, stamps ``request["_stream"]`` (the table key)
      and, when the held flow matches this frame's padded bucket,
      ``request["_flow_init"]`` and ``_converge_tol``;
    - the serving path (scheduler or :func:`stream_infer`) attaches the
      exiting row's low-res flow as ``request["_stream_flow"]`` /
      ``request["_stream_shape"]``;
    - :meth:`deposit` (response resolution, BEFORE the Future resolves, so
      a client that waits for frame N and then posts frame N+1 is
      guaranteed a warm join) stores it back into the session, or counts a
      drop when the session expired or was evicted mid-flight.
    """

    def __init__(self, session, *, registry=None,
                 max_sessions: Optional[int] = None,
                 ttl_ms: Optional[float] = None,
                 converge_tol: Optional[float] = None,
                 per_tenant: Optional[int] = None):
        self.session = session
        self.registry = registry if registry is not None else session.registry
        self.max_sessions = resolve_stream_sessions(max_sessions)
        self.ttl_s = resolve_stream_ttl_ms(ttl_ms) / 1e3
        self.converge_tol = resolve_converge_tol(converge_tol)
        # An eighth of the global cap (>= 1): one hostile tenant cannot
        # occupy the whole table.
        self.per_tenant = (int(per_tenant) if per_tenant is not None
                           else max(1, self.max_sessions // 8))
        self._lock = threading.Lock()
        self._table: "OrderedDict[Tuple[str, str], StreamSession]" = OrderedDict()
        self._per_tenant: Dict[str, int] = {}
        # Round-robin cursor for chip placement (mutated under _lock).
        self._rr_chip = 0
        reg = self.registry
        self._g_sessions = reg.gauge(
            "raft_stream_sessions", "live stream sessions (LRU+TTL bounded table)")
        self._c_created = reg.counter(
            "raft_stream_sessions_created_total", "stream sessions created")
        self._c_evicted = reg.counter(
            "raft_stream_sessions_evicted_total",
            "stream sessions evicted (global or per-tenant cap)")
        self._c_expired = reg.counter(
            "raft_stream_sessions_expired_total", "stream sessions expired by TTL")
        self._c_dropped = reg.counter(
            "raft_stream_deposits_dropped_total",
            "flow deposits dropped because the session expired/evicted mid-flight")
        self._c_warm = reg.counter(
            "raft_stream_warm_joins_total",
            "frames that actually warm-started (prepare_warm ran)")
        self._c_converged = reg.counter(
            "raft_stream_converged_total",
            "rows that exited early through the convergence monitor")

    # -- table maintenance (caller holds self._lock) -----------------------

    def _drop_locked(self, key: Tuple[str, str]) -> None:
        sess = self._table.pop(key, None)
        if sess is None:
            return
        n = self._per_tenant.get(sess.tenant, 1) - 1
        if n <= 0:
            self._per_tenant.pop(sess.tenant, None)
        else:
            self._per_tenant[sess.tenant] = n

    def _sweep_locked(self, now: float) -> None:
        expired = [k for k, s in self._table.items() if now - s.last_seen > self.ttl_s]
        for k in expired:
            self._drop_locked(k)
        if expired:
            self._c_expired.inc(len(expired))

    def _create_locked(self, key: Tuple[str, str], now: float) -> StreamSession:
        tenant = key[0]
        # Per-tenant cap first (a tenant at its own cap must not push OTHER
        # tenants' sessions out), then the global cap: both evict the
        # victim population's least recently used session, counted.
        if self._per_tenant.get(tenant, 0) >= self.per_tenant:
            victim = next((k for k, s in self._table.items() if s.tenant == tenant), None)
            if victim is not None:
                self._drop_locked(victim)
                self._c_evicted.inc()
        while len(self._table) >= self.max_sessions:
            victim = next(iter(self._table))
            self._drop_locked(victim)
            self._c_evicted.inc()
        chip = None
        n_chips = getattr(self.session, "mesh_chips", 1)
        if getattr(self.session, "mesh_active", False) and n_chips > 1:
            chip = self._rr_chip % n_chips
            self._rr_chip += 1
        sess = self._table[key] = StreamSession(key, now, chip=chip)
        self._per_tenant[tenant] = self._per_tenant.get(tenant, 0) + 1
        self._c_created.inc()
        return sess

    def _touch_locked(self, key: Tuple[str, str], now: float) -> StreamSession:
        sess = self._table.get(key)
        if sess is None:
            return self._create_locked(key, now)
        self._table.move_to_end(key)
        return sess

    def _clear_locked(self) -> int:
        n = len(self._table)
        self._table.clear()
        self._per_tenant.clear()
        return n

    def _migrate_locked(self, bad: set, n_chips: int) -> int:
        # Reassign sessions pinned to a bad chip, or to an ordinal past a
        # shrunken mesh, round-robin over the survivors (None when 1-wide).
        migrated = 0
        for sess in self._table.values():
            if sess.chip is None:
                continue
            if sess.chip in bad or sess.chip >= max(1, n_chips):
                if n_chips > 1:
                    sess.chip = self._rr_chip % n_chips
                    self._rr_chip += 1
                else:
                    sess.chip = None
                migrated += 1
        return migrated

    def _repin_unplaced_locked(self, n_chips: int) -> int:
        repinned = 0
        for sess in self._table.values():
            if sess.chip is not None:
                continue
            sess.chip = self._rr_chip % n_chips
            self._rr_chip += 1
            repinned += 1
        return repinned

    # -- the request protocol ----------------------------------------------

    def admit(self, request: Dict) -> None:
        """Stamp one validated request (arrays already canonical). A
        request without ``stream`` passes through untouched except for
        normalizing an explicit ``converge_tol`` field: any request may opt
        into the convergence exit without a session."""
        if request.get("_converge_tol") is None and request.get("converge_tol") is not None:
            tol = float(request["converge_tol"])
            if not (tol >= 0) or not np.isfinite(tol):
                tol = 0.0
            request["_converge_tol"] = tol
        sid = request.get("stream")
        if sid is None:
            return
        key = (sanitize_tenant(request.get("tenant")), sanitize_tenant(str(sid)))
        now = self.session.clock.now()
        padded = self.session.padder_for(request["left"].shape).padded_shape
        with self._lock:
            self._sweep_locked(now)
            sess = self._touch_locked(key, now)
            sess.last_seen = now
            sess.frames += 1
            request["_stream"] = key
            if sess.chip is not None:
                request["_chip"] = sess.chip
            if sess.flow is not None and sess.padded_shape == padded:
                # Warm frame: hand out the held seed. A shape change goes
                # cold: the held field is for another bucket.
                sess.warm_frames += 1
                request["_flow_init"] = sess.flow
                if request.get("_converge_tol") is None:
                    request["_converge_tol"] = self.converge_tol
            self._g_sessions.set(len(self._table))

    def deposit(self, request: Dict, resp: Dict) -> None:
        """Store a served frame's low-res flow back into its session. Runs
        on the response-resolution path of both serving modes and never
        raises."""
        key = request.get("_stream")
        flow = request.pop("_stream_flow", None)
        shape = request.pop("_stream_shape", None)
        if key is None or resp.get("status") != "ok" or flow is None:
            return
        now = self.session.clock.now()
        with self._lock:
            self._sweep_locked(now)
            self._g_sessions.set(len(self._table))
            sess = self._table.get(key)
            if sess is None:
                # Expired or evicted while this frame was in flight: the
                # next frame of that stream starts cold.
                self._c_dropped.inc()
                return
            sess.flow = np.asarray(flow, dtype=np.float32)
            sess.padded_shape = tuple(shape) if shape is not None else None
            sess.last_seen = now

    # -- serving-path accounting -------------------------------------------

    def note_warm_join(self, tenant_label: str) -> None:
        """One frame actually warm-started (its prepare_warm ran). Counted
        where it happens, not at stamping."""
        self._c_warm.inc()
        self.session.usage.note_stream(tenant_label, warm_join=True)

    def note_converged(self, tenant_label: str) -> None:
        """One row exited early through the convergence monitor."""
        self._c_converged.inc()
        self.session.usage.note_stream(tenant_label, converged=True)

    def migrate_off_chips(self, quarantined, n_chips: int) -> int:
        """Reassign every session pinned to a quarantined chip, or to an
        ordinal past the shrunken mesh, onto a surviving data shard. The
        held flow is host memory, so a migrated stream stays warm. Returns
        the number of sessions migrated (0 off the mesh)."""
        with self._lock:
            migrated = self._migrate_locked(set(int(c) for c in quarantined), int(n_chips))
        if migrated:
            self.registry.counter("raft_stream_migrations_total",
                                  "stream sessions migrated off quarantined chips"
                                  ).inc(migrated)
        return migrated

    def repin_unplaced(self, n_chips: int) -> int:
        """Re-pin sessions parked off-mesh round-robin over a re-grown
        mesh. Returns the number re-pinned (0 when the mesh is 1-wide)."""
        n_chips = int(n_chips)
        if n_chips <= 1:
            return 0
        with self._lock:
            repinned = self._repin_unplaced_locked(n_chips)
        if repinned:
            self.registry.counter("raft_stream_migrations_total",
                                  "stream sessions migrated off quarantined chips"
                                  ).inc(repinned)
        return repinned

    # -- lifecycle ---------------------------------------------------------

    def drop_all(self) -> int:
        """Service stop/drain: every session dies (held flow freed, gauge
        zeroed). In-flight deposits after this land as counted drops."""
        with self._lock:
            n = self._clear_locked()
            self._g_sessions.set(0)
        return n

    # -- reporting ---------------------------------------------------------

    def status(self) -> Dict:
        """The /healthz ``stream`` block, bounded by construction."""
        with self._lock:
            per_tenant = dict(sorted(self._per_tenant.items()))
            n = len(self._table)
            by_chip: Dict[str, int] = {}
            for sess in self._table.values():
                if sess.chip is not None:
                    k = str(sess.chip)
                    by_chip[k] = by_chip.get(k, 0) + 1
        return {
            "sessions": n,
            "by_chip": by_chip,
            "max_sessions": self.max_sessions,
            "per_tenant_cap": self.per_tenant,
            "per_tenant": per_tenant,
            "ttl_ms": self.ttl_s * 1e3,
            "converge_tol": self.converge_tol,
            "created": int(self._c_created.value),
            "evicted": int(self._c_evicted.value),
            "expired": int(self._c_expired.value),
            "deposits_dropped": int(self._c_dropped.value),
            "warm_joins": int(self._c_warm.value),
            "converged_exits": int(self._c_converged.value),
        }


# ---------------------------------------------------------------------------
# Sequential streaming inference: the worker-pool and demo twin of the
# scheduler's warm path, on the b=1 prepare[_warm]/advance/epilogue
# programs. With no early exit the composition is bit for bit the "full"
# program (the loop runs the same iterations in segments), which is what
# makes a stream's first frame byte-identical to the stateless response.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamOutcome:
    """One served stream frame and the seed for the next one."""

    result: InferenceResult
    flow_low: np.ndarray            # (1, H/f, W/f, 1) fp32, padded bucket
    padded_shape: Tuple[int, int]
    warm: bool = False              # the prepare_warm program ran
    dnorms: Tuple[float, ...] = ()  # the advance norm of each segment run


def _flow_matches(flow_init: Optional[np.ndarray], session, ph: int, pw: int) -> bool:
    if flow_init is None:
        return False
    factor = session._run_cfg.downsample_factor
    return tuple(flow_init.shape) == (1, ph // factor, pw // factor, 1)


def _attempt(session, padder, left, right, *, flow_init, converge_tol, deadline, trace):
    """One ladder attempt of the segmented stream loop. Returns
    ``(flow_up_padded, flow_low, quality, iters_done, warm, dnorms)``."""
    clock = session.clock
    segments = session.cfg.segments
    m = session.cfg.valid_iters // segments
    ph, pw = padder.padded_shape
    with trace.span("pad"):
        lp, rp = padder.pad_np(left, right)

    warm = _flow_matches(flow_init, session, ph, pw)
    if warm:
        prep = session.get_program("prepare_warm", ph, pw, 0)
        (state,) = session.invoke(prep, lp, rp, np.ascontiguousarray(flow_init, np.float32),
                                  trace=trace)
    else:
        prep = session.get_program("prepare", ph, pw, 0)
        (state,) = session.invoke(prep, lp, rp, trace=trace)
    adv = session.get_program("advance", ph, pw, m)

    done = 0
    dnorms = []
    converged = False
    reduced = False
    for _ in range(segments):
        if done:  # a best-so-far exists: the deadline checks mirror degrade
            now = clock.now()
            est = session.estimate(adv.key)
            if deadline is not None and (
                    now >= deadline or (est is not None and now + est * SAFETY > deadline)):
                reduced = True
                trace.event("degrade", label=f"reduced_iters:{done}",
                            reason=("deadline_expired" if now >= deadline
                                    else "predicted_overshoot"))
                break
        state, _rowsum, dnorm = session.invoke(adv, state, trace=trace)
        done += m
        dnorms.append(float(dnorm[0]))
        if converge_tol is not None and done < session.cfg.valid_iters \
                and dnorms[-1] < converge_tol:
            converged = True
            trace.event("converged", label=f"converged:{done}", norm=dnorms[-1],
                        tol=converge_tol)
            break
    epi = session.get_program("epilogue", ph, pw, 0)
    flow_up, flow_low = session.invoke(epi, state, trace=trace)
    if done >= session.cfg.valid_iters:
        quality = "full"
    elif converged:
        quality = f"converged:{done}"
    else:  # the only other early exit is the deadline path
        assert reduced, "early exit with neither converged nor reduced"
        quality = f"reduced_iters:{done}"
    return flow_up, flow_low, quality, done, warm, tuple(dnorms)


def stream_infer(session, left, right, *,
                 flow_init: Optional[np.ndarray] = None,
                 converge_tol: Optional[float] = None,
                 deadline: Optional[float] = None,
                 prevalidated: bool = False,
                 trace=NULL_TRACE) -> StreamOutcome:
    """Serve one stream frame sequentially (b=1 programs).

    ``InferenceSession.infer``'s contract (breaker-ladder retries, output
    validation, honest quality labels, session counters) on the segmented
    prepare[_warm]/advance/epilogue composition, so warm starts and
    convergence exits engage. ``flow_init`` must be the padded-bucket
    low-res field a previous :class:`StreamOutcome` carried (a shape
    mismatch is a cold start, never an error).
    """
    from raft_stereo_tpu_torch.serve.validate import validate_pair

    t_start = session.clock.now()
    try:
        if not prevalidated:
            left, right = validate_pair(left, right, session.cfg.admission)
        orig_h, orig_w = left.shape[1], left.shape[2]
        padder = session.padder_for(left.shape)
        tripped = []
        for _ in range(len(session.breaker.ladder) + 1):
            try:
                flow_up, flow_low, quality, done, warm, dnorms = _attempt(
                    session, padder, left, right, flow_init=flow_init,
                    converge_tol=converge_tol, deadline=deadline, trace=trace)
                break
            except Exception as e:  # noqa: BLE001 — _handle_failure filters
                # A fatal failure or a refused rung ends in a structured
                # error; anything but a kernel failure propagates.
                tripped.append(session._handle_failure(e, traces=(trace,)))
                padder = session.padder_for(left.shape)
        else:
            raise InferenceFailed("ladder_exhausted",
                                  f"breaker retries exhausted, tripped {tripped}")

        with trace.span("unpad"):
            disparity = session._finish(flow_up, padder, quality, orig_h, orig_w)
        session.count_request(ok=True, degraded=quality != "full")
        result = InferenceResult(
            disparity=disparity, quality=quality, iters=done,
            elapsed_s=session.clock.now() - t_start, padded_shape=padder.padded_shape,
            deadline_missed=(deadline is not None and session.clock.now() > deadline),
            tripped=tuple(tripped))
        return StreamOutcome(result=result, flow_low=np.asarray(flow_low, np.float32),
                             padded_shape=padder.padded_shape, warm=warm, dnorms=dnorms)
    except Exception as e:
        session.count_request(ok=False, nonfinite=(isinstance(e, InferenceFailed)
                                                   and e.code == "nonfinite_output"))
        raise


class StreamRunner:
    """In-process stream driver over one :class:`InferenceSession`, what
    ``demo --video`` runs. Holds one stream's state (the previous frame's
    low-res flow) and feeds each frame through :func:`stream_infer`.

    The first frame (no held flow) runs the cold segmented composition at
    full ``valid_iters`` with no convergence exit unless ``converge_cold``
    opts in: byte-identical to the stateless single-pair response.
    ``last`` is the latest frame's :class:`StreamOutcome`.
    """

    def __init__(self, session, *, converge_tol: Optional[float] = None,
                 converge_cold: bool = False):
        self.session = session
        self.converge_tol = resolve_converge_tol(converge_tol)
        self.converge_cold = converge_cold
        self._flow: Optional[np.ndarray] = None
        self._shape: Optional[Tuple[int, int]] = None
        self.frames = 0
        self.warm_frames = 0
        self.last: Optional[StreamOutcome] = None

    def reset(self) -> None:
        self._flow = None
        self._shape = None

    def infer(self, left, right, *, deadline=None, trace=NULL_TRACE) -> InferenceResult:
        padded = self.session.padder_for(np.asarray(left).shape).padded_shape
        flow = self._flow if self._shape == padded else None
        warm = flow is not None
        tol = self.converge_tol if (warm or self.converge_cold) else None
        out = stream_infer(self.session, left, right, flow_init=flow, converge_tol=tol,
                           deadline=deadline, trace=trace)
        self._flow = out.flow_low
        self._shape = out.padded_shape
        self.frames += 1
        if warm:
            self.warm_frames += 1
        self.last = out
        return out.result
