"""Content-addressed response cache: an exact tier and a near tier.

The port's counterpart of the JAX package's ``serve/cache.py``, with the
same knobs, metrics, labels and request protocol. A hit costs zero device
seconds:

- **exact tier**: key = sha256 of the PADDED input pair bytes + the port
  session's live program fingerprint + the serving tier (``valid_iters``)
  + the sanitized tenant -> the stored response, served from a
  byte-accounted host-RAM LRU (``RAFT_CACHE_BYTES``; optional
  ``RAFT_CACHE_DIR`` disk spill for evicted entries). Bit for bit a
  recompute BY CONSTRUCTION: only cold, full-quality responses are
  deposited (a warm-seeded or degraded output is not the cold program's
  bytes and is refused), and the fingerprint folded into every key means a
  config change or breaker trip can never serve a stale program's output.
  Hits are labeled ``cache:exact`` and move no device counter, no deck row
  and no usage nanosecond;

- **near tier**: a block-mean signature of the padded left image
  (``SIG_GRID`` x ``SIG_GRID`` grayscale block means, 1 KiB) -> the nearest
  stored neighbor of the SAME tenant, shape and fingerprint within an L1
  threshold (``RAFT_CACHE_NEAR_TOL`` gray levels; 0 = tier off) -> the
  request's ``coords1`` is seeded from the neighbor's 1/8-res x-only
  disparity through the ``prepare_warm`` program (the stream module's
  warm-start contract: no new program, no stream session). Near hits ride
  the normal serving path and exit through the convergence monitor,
  labeled ``warm:cache:<iterations run>``;

- **lifecycle**: a global byte budget with LRU eviction, per-tenant
  sub-caps with own-LRU eviction (a tenant at its cap evicts its own
  oldest entry, never another tenant's), a lazy TTL sweep on the session
  clock (``RAFT_CACHE_TTL_MS``), deposit-before-resolve (a client that
  reads response N and resubmits the same frame is guaranteed a hit),
  ``drop_all()`` on service stop and drain; entry count is bounded by the
  byte budget and metric labels ride the usage module's first-come bound.

Tenancy is part of the KEY: tenant A's scene is never served to tenant B,
even for identical uploads (a cache shared across tenants would be an
oracle: upload a guessed image, observe the hit).

**The spill format is the port's own**: one ``.npz`` per entry (the
disparity, the signature, the seed and a JSON ``meta`` that holds the
entry's full key), written under a temporary name unique to the writer
(pid and a counter) and published by ``os.replace``, so two writers of one
key never tear each other's file; a file whose key does not match, or that
does not load, is a miss. It does not read the JAX package's spills (their
keys hold another fingerprint).

One 2016x2976 entry holds the float32 disparity (~24 MiB), the 1/8-res
seed (~0.4 MiB) and the signature, so the CLI's 256 MiB budget holds ~10
full-resolution scenes; ``raft_cache_bytes`` is the accounted truth.

Pure host state: numpy and the standard library.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from raft_stereo_tpu_torch.obs.tracing import NULL_TRACE
from raft_stereo_tpu_torch.obs.usage import sanitize_tenant
# ONE named-ValueError parser for env knobs (the SLURM_CPUS_PER_TASK
# convention) — the ``os.environ`` reads stay LITERAL at each resolve_*
# site below so the knob registry's cross-check can see them.
from raft_stereo_tpu_torch.serve.supervise import _parse_number

logger = logging.getLogger(__name__)

#: Host-RAM budget the CLI defaults to (serve_stereo.py --cache_bytes).
#: The LIBRARY default is 0 = disabled, as the watchdog's:
#: embedded sessions and test rigs must opt in, production CLIs default
#: it on.
DEFAULT_CACHE_BYTES = 256 << 20

#: Idle entries expire after this long on the session clock: a rig that
#: went away must not pin stale scenes until eviction pressure arrives.
DEFAULT_CACHE_TTL_MS = 600_000.0

#: Near-tier L1 threshold in gray levels over the block-mean signature;
#: 0 disables the tier entirely (no signature scan, no seed stamping).
DEFAULT_CACHE_NEAR_TOL = 0.0

#: Perceptual-signature grid: the padded left image reduces to this many
#: grayscale block means per side (padded shapes are multiples of 32, so
#: the grid always divides evenly enough to crop losslessly).
SIG_GRID = 16

#: Bound on the near-tier candidate scan (MRU-first): the linear scan
#: must stay cheap even when the byte budget holds thousands of tiny
#: entries.  Candidates beyond this are simply not considered — bounded
#: work beats an exhaustive nearest-neighbor search on the serving path.
NEAR_SCAN_BOUND = 512

#: Fixed per-entry bookkeeping charge (key tuple, dict slots, OrderedDict
#: node) folded into the byte accounting so a hostile flood of tiny
#: entries cannot grow host memory past the budget on overheads alone.
ENTRY_OVERHEAD = 512


def resolve_cache_bytes(value: Optional[int] = None) -> int:
    """Effective host-RAM budget in bytes: explicit config wins, else
    ``RAFT_CACHE_BYTES``, else 0 (disabled — the library default; the
    serving CLI defaults it to :data:`DEFAULT_CACHE_BYTES`).  Host-side
    response storage only — no compiled program depends on it
    (HOST_ENV_KNOBS rationale)."""
    if value is not None:
        return int(value)
    raw = os.environ.get("RAFT_CACHE_BYTES", "").strip()
    if not raw:
        return 0
    n = _parse_number("RAFT_CACHE_BYTES", raw, int)
    if n < 0:
        raise ValueError(f"RAFT_CACHE_BYTES must be >= 0, got {n}")
    return n


def resolve_cache_ttl_ms(value: Optional[float] = None) -> float:
    """Effective entry TTL in ms: explicit config wins, else
    ``RAFT_CACHE_TTL_MS``, else 10 minutes."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_CACHE_TTL_MS", "").strip()
    if not raw:
        return DEFAULT_CACHE_TTL_MS
    ttl = _parse_number("RAFT_CACHE_TTL_MS", raw, float)
    if ttl <= 0:
        raise ValueError(f"RAFT_CACHE_TTL_MS must be > 0, got {ttl}")
    return ttl


def resolve_cache_near_tol(value: Optional[float] = None) -> float:
    """Effective near-tier threshold (gray levels over the block-mean
    signature): explicit config wins, else ``RAFT_CACHE_NEAR_TOL``, else
    0 = disabled.  A HOST-side comparison only — the threshold never
    reaches a trace (the seed it hands out feeds the existing
    ``prepare_warm`` program unchanged), so it stays out of the program
    fingerprint exactly like ``RAFT_CONVERGE_TOL``."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_CACHE_NEAR_TOL", "").strip()
    if not raw:
        return DEFAULT_CACHE_NEAR_TOL
    tol = _parse_number("RAFT_CACHE_NEAR_TOL", raw, float)
    if tol < 0:
        raise ValueError(f"RAFT_CACHE_NEAR_TOL must be >= 0, got {tol}")
    return tol


def resolve_cache_dir(value: Optional[str] = None) -> Optional[str]:
    """Effective disk-spill directory: explicit config wins, else
    ``RAFT_CACHE_DIR``, else None (RAM only).  Exact-tier entries
    evicted from RAM spill here (bounded by the same byte budget again,
    oldest-file pruning) and are promoted back on a later exact match —
    the near tier deliberately scans RAM only."""
    if value is not None:
        return str(value) or None
    raw = os.environ.get("RAFT_CACHE_DIR", "").strip()
    return raw or None


def block_signature(padded_left: np.ndarray) -> np.ndarray:
    """The near tier's perceptual signature: ``SIG_GRID x SIG_GRID``
    grayscale block means over the padded left image — cheap (one mean
    reduction), shift-tolerant at the block scale, and 1 KiB to hold.
    Input is the canonical padded ``(1, H, W, 3)`` float32 array."""
    g = np.asarray(padded_left, dtype=np.float32)[0].mean(axis=2)
    h, w = g.shape
    bh, bw = max(1, h // SIG_GRID), max(1, w // SIG_GRID)
    gh, gw = min(SIG_GRID, h), min(SIG_GRID, w)
    g = g[:bh * gh, :bw * gw]
    return g.reshape(gh, bh, gw, bw).mean(axis=(1, 3)).astype(np.float32)


def signature_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute block-mean difference, in gray levels (the unit
    ``RAFT_CACHE_NEAR_TOL`` is expressed in)."""
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).mean())


class CacheEntry:
    """One stored cold full-quality response.  Immutable once deposited
    (hits serve copies); bookkeeping fields mutate only under the
    cache's lock."""

    __slots__ = ("key", "tenant", "label", "sig", "disparity", "flow",
                 "padded_shape", "iters", "nbytes", "created", "last_used")

    def __init__(self, key: Tuple, tenant: str, label: str,
                 sig: np.ndarray, disparity: np.ndarray,
                 flow: Optional[np.ndarray],
                 padded_shape: Optional[Tuple[int, int]],
                 iters: int, now: float):
        self.key = key
        self.tenant = tenant
        self.label = label
        self.sig = sig
        self.disparity = disparity
        self.flow = flow
        self.padded_shape = padded_shape
        self.iters = iters
        self.nbytes = (int(disparity.nbytes) + int(sig.nbytes)
                       + (int(flow.nbytes) if flow is not None else 0)
                       + ENTRY_OVERHEAD)
        self.created = now
        self.last_used = now


class ResponseCache:
    """Two-tier, bounded, tenant-isolated response cache over one
    :class:`~raft_stereo_tpu_torch.serve.session.InferenceSession`.

    Protocol (all on the request dict, so bounces/retries carry it for
    free — the StreamManager's stance):

    - :meth:`admit` (service admission, after validation): computes the
      exact key + perceptual signature, stamps ``request["_cache_key"]``
      / ``_cache_sig``, and EITHER returns a complete served response
      (exact hit, ``cache:exact``) or stamps the near-tier warm seed
      (``_flow_init`` + ``_cache_warm`` + a default ``_converge_tol``)
      and returns None;
    - the serving path attaches the computed response's 1/8-res flow as
      ``request["_cache_flow"]`` / ``_cache_shape`` (the scheduler does
      this for every batched exit; the sequential path does when it runs
      the segmented composition);
    - :meth:`deposit` (response resolution, BEFORE the Future resolves)
      stores cold full-quality responses back — warm-seeded, degraded,
      failed or fingerprint-stale responses are refused, which is what
      makes every exact hit bit-identical to a cold recompute.
    """

    def __init__(self, session, *, max_bytes: Optional[int] = None,
                 ttl_ms: Optional[float] = None,
                 near_tol: Optional[float] = None,
                 cache_dir: Optional[str] = None,
                 per_tenant_bytes: Optional[int] = None,
                 default_converge_tol: Optional[float] = None,
                 registry=None):
        self.session = session
        self.registry = registry if registry is not None else \
            session.registry
        self.max_bytes = resolve_cache_bytes(max_bytes)
        self.ttl_s = resolve_cache_ttl_ms(ttl_ms) / 1e3
        self.near_tol = resolve_cache_near_tol(near_tol)
        self.dir = resolve_cache_dir(cache_dir)
        # Per-tenant sub-cap: an eighth of the global budget (>= 1 byte),
        # the quota/stream stance — generous for a real rig, bounding for
        # an adversary.  A tenant may always hold at least ONE entry (its
        # own-LRU eviction empties its account first), so a sub-cap below
        # one entry degrades to "one scene per tenant", never to a tenant
        # that can cache nothing.
        self.per_tenant = (int(per_tenant_bytes)
                           if per_tenant_bytes is not None
                           else max(1, self.max_bytes // 8))
        # Default convergence tolerance stamped on near-seeded requests
        # that carry none of their own (the service passes its stream
        # default so both warm-start flavors exit by one rule).
        self.default_converge_tol = default_converge_tol
        self._lock = threading.Lock()
        self._table: "OrderedDict[Tuple, CacheEntry]" = OrderedDict()
        self._total_bytes = 0
        self._tenant_bytes: Dict[str, int] = {}   # RAW sanitized tenant
        self._label_bytes: Dict[str, int] = {}    # bounded metric label
        # Disk-spill state, guarded by its OWN lock: file IO must never
        # serialize behind the RAM table's serving-path lock.
        self._disk_lock = threading.Lock()
        self._disk_bytes = 0
        reg = self.registry
        self._c_hits = reg.counter(
            "raft_cache_hits_total",
            "exact-tier response-cache hits (zero device seconds)")
        self._c_misses = reg.counter(
            "raft_cache_misses_total",
            "response-cache lookups that found no exact entry")
        self._c_near = reg.counter(
            "raft_cache_near_hits_total",
            "near-tier warm-start seeds handed out (prepare_warm rides "
            "the request)")
        self._c_evicted = reg.counter(
            "raft_cache_evictions_total",
            "entries evicted by the byte budget or a tenant sub-cap")
        self._c_expired = reg.counter(
            "raft_cache_expired_total", "entries expired by TTL")
        self._c_deposits = reg.counter(
            "raft_cache_deposits_total",
            "cold full-quality responses stored")
        self._c_refused = reg.counter(
            "raft_cache_deposits_refused_total",
            "deposits refused (warm-seeded, degraded, fingerprint-stale "
            "or oversize) — refusal is the bit-exactness guarantee")
        self._c_disk_hits = reg.counter(
            "raft_cache_disk_hits_total",
            "exact hits served by promoting a spilled entry from "
            "RAFT_CACHE_DIR")
        self._c_spills = reg.counter(
            "raft_cache_spills_total",
            "evicted entries spilled to RAFT_CACHE_DIR")
        self._g_bytes = reg.gauge(
            "raft_cache_bytes",
            "accounted bytes held by the response cache (bounded by "
            "RAFT_CACHE_BYTES)")
        self._g_entries = reg.gauge(
            "raft_cache_entries", "live response-cache entries")
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            with self._disk_lock:
                self._disk_bytes = sum(
                    e.stat().st_size for e in os.scandir(self.dir)
                    if e.is_file() and e.name.endswith(".npz"))

    # -- properties --------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    @property
    def wants_flow(self) -> bool:
        """Whether the serving path should produce (and attach) the
        1/8-res flow for deposits: only the near tier consumes it, so a
        near_tol of 0 keeps the sequential path on its classic route."""
        return self.enabled and self.near_tol > 0

    @property
    def hits_cumulative(self) -> int:
        """Exact + near hits served so far — the deck tick column."""
        return int(self._c_hits.value) + int(self._c_near.value)

    # -- key material ------------------------------------------------------

    def _key_for(self, tenant: str, ph: int, pw: int,
                 digest: str) -> Tuple:
        # The LIVE fingerprint: a breaker trip or config change re-keys
        # every lookup AND every deposit instantly — a stale program's
        # output is structurally unreachable (the program cache's staleness rule,
        # applied to responses).  valid_iters is the serving tier: two
        # sessions at different iteration budgets never share an answer.
        return (tenant, ph, pw, int(self.session.cfg.valid_iters),
                self.session.fingerprint_id(), digest)

    # -- the request protocol ----------------------------------------------

    def admit(self, request: Dict) -> Optional[Dict]:
        """One validated request (arrays already canonical): exact-tier
        lookup, near-tier seed stamping.  Returns a complete served
        response on an exact hit, None otherwise.  Never raises on the
        serving path — a cache bug must degrade to a miss, not a failed
        request."""
        if not self.enabled:
            return None
        try:
            return self._admit(request)
        except Exception:  # noqa: BLE001 — the cache must fail open
            logger.exception("response-cache admit failed — serving as "
                             "a miss")
            return None

    def _admit(self, request: Dict) -> Optional[Dict]:
        tenant = sanitize_tenant(request.get("tenant"))
        label = self.session.usage.label(tenant)
        trace = request.get("_trace") or NULL_TRACE
        left, right = request["left"], request["right"]
        padder = self.session.padder_for(left.shape)
        ph, pw = padder.padded_shape
        # Deliberate trade-off: this pad is a second full-frame copy on
        # the miss path (the uploader/stream path pads the same pair
        # again later), but attaching the padded arrays to the request
        # for reuse would pin ~2x the host RAM per QUEUED request for
        # its whole queue wait — compute is cheap and flat, resident
        # memory under backlog is not.
        lp, rp = padder.pad_np(left, right)
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(lp).tobytes())
        h.update(np.ascontiguousarray(rp).tobytes())
        key = self._key_for(tenant, ph, pw, h.hexdigest())
        sig = block_signature(lp)
        request["_cache_key"] = key
        request["_cache_sig"] = sig
        now = self.session.clock.now()
        t0 = now
        with self._lock:
            self._sweep(now)
            entry = self._touch(key, now)
        if entry is None and self.dir:
            entry = self._disk_lookup(key, tenant, label, now)
        if entry is not None:
            self._c_hits.inc()
            self.session.usage.note_cache(label, exact=True)
            trace.event("cache", tier="exact",
                        age_s=now - entry.created)
            if request.get("_stream") is not None and \
                    entry.flow is not None:
                # A stream member hitting the exact tier still keeps its
                # session warm: the entry's held flow rides the request
                # into the service's stream deposit hook.
                request["_cache_stream_flow"] = entry.flow
                request["_cache_stream_shape"] = entry.padded_shape
            return {
                "status": "ok",
                "quality": "cache:exact",
                "disparity": entry.disparity.copy(),
                "iters": entry.iters,
                "elapsed_ms": (self.session.clock.now() - t0) * 1e3,
                "deadline_missed": False,
            }
        self._c_misses.inc()
        self.session.usage.note_cache(label, miss=True)
        # Near tier: only when armed, and never over a stream session's
        # own seed (the previous frame of the SAME stream is a strictly
        # better prior than any neighbor).
        if self.near_tol > 0 and request.get("_flow_init") is None:
            neighbor, dist = self._nearest(tenant, ph, pw, key[4], sig)
            if neighbor is not None:
                request["_flow_init"] = neighbor.flow
                request["_cache_warm"] = True
                if request.get("_converge_tol") is None and \
                        self.default_converge_tol is not None:
                    request["_converge_tol"] = self.default_converge_tol
                self._c_near.inc()
                self.session.usage.note_cache(label, near=True)
                trace.event("cache", tier="near", distance=dist,
                            tol=self.near_tol)
        return None

    def _nearest(self, tenant: str, ph: int, pw: int, fp: str,
                 sig: np.ndarray):
        """Bounded MRU-first scan for the nearest same-tenant, same-
        bucket, same-fingerprint entry holding a seed.  RAM only (disk
        entries are exact-tier material)."""
        with self._lock:
            candidates = [e for e in reversed(self._table.values())
                          if e.tenant == tenant and e.flow is not None
                          and e.key[1] == ph and e.key[2] == pw
                          and e.key[4] == fp][:NEAR_SCAN_BOUND]
        best, best_d = None, float("inf")
        for e in candidates:
            d = signature_distance(sig, e.sig)
            if d < best_d:
                best, best_d = e, d
        if best is not None and best_d <= self.near_tol:
            return best, best_d
        return None, best_d

    def deposit(self, request: Dict, resp: Dict) -> None:
        """Store one resolved response — BEFORE its Future resolves, so
        an immediate resubmission of the same frame is guaranteed a hit.
        Runs on the response-resolution path for both serving modes and
        must never raise.  Only COLD (no warm seed), FULL-quality, ok
        responses under the LIVE fingerprint are stored: everything else
        is refused and counted — refusal is what makes every exact hit
        bit-identical to a cold recompute by construction."""
        key = request.get("_cache_key")
        flow = request.pop("_cache_flow", None)
        shape = request.pop("_cache_shape", None)
        if not self.enabled or key is None:
            return
        try:
            self._deposit(request, resp, key, flow, shape)
        except Exception:  # noqa: BLE001 — the cache must fail open
            logger.exception("response-cache deposit failed — entry "
                             "dropped")

    def _deposit(self, request: Dict, resp: Dict, key: Tuple,
                 flow, shape) -> None:
        if resp.get("status") != "ok" or resp.get("quality") != "full" \
                or request.get("_flow_init") is not None:
            self._c_refused.inc()
            return
        if key[4] != self.session.fingerprint_id():
            # The program set changed (breaker trip) between admission
            # and resolution: this output came from a program the key
            # does not describe — refuse, never poison.
            self._c_refused.inc()
            return
        sig = request.get("_cache_sig")
        if sig is None:
            self._c_refused.inc()
            return
        disparity = np.array(resp["disparity"], dtype=np.float32,
                             copy=True)
        flow_arr = (np.array(flow, dtype=np.float32, copy=True)
                    if flow is not None else None)
        tenant = key[0]
        label = self.session.usage.label(tenant)
        now = self.session.clock.now()
        entry = CacheEntry(key, tenant, label, np.asarray(sig), disparity,
                           flow_arr,
                           tuple(shape) if shape is not None else None,
                           int(resp.get("iters", 0)), now)
        if entry.nbytes > self.max_bytes:
            self._c_refused.inc()
            return
        with self._lock:
            self._sweep(now)
            if self._touch(key, now) is not None:
                # Re-deposit of a live entry (two identical cold
                # requests racing): refresh recency, keep the bytes.
                return
            evicted = self._store(entry)
        self._c_deposits.inc()
        self._note_evictions(evicted)

    def _note_evictions(self, evicted: List[CacheEntry]) -> None:
        """Post-eviction accounting shared by every path that calls
        ``_store``: global + per-tenant counters, and the disk spill —
        a victim must be persisted (and counted to its owner) whether
        the pressure came from a deposit or a disk promotion."""
        if not evicted:
            return
        self._c_evicted.inc(len(evicted))
        for e in evicted:
            self.registry.counter(
                "raft_tenant_cache_evictions_total",
                "response-cache evictions by owning tenant "
                "(first-come-bounded labels)", tenant=e.label).inc()
        if self.dir:
            for e in evicted:
                self._spill(e)

    # -- table maintenance (caller holds self._lock — the StreamManager
    # -- lock-held-helper discipline: every mutation of
    # -- the table/byte books lives in these bare helpers) -----------------

    def _touch(self, key: Tuple, now: float) -> Optional[CacheEntry]:
        entry = self._table.get(key)
        if entry is not None:
            self._table.move_to_end(key)
            entry.last_used = now
        return entry

    def _store(self, entry: CacheEntry) -> List[CacheEntry]:
        evicted = self._make_room(entry)
        self._table[entry.key] = entry
        self._account(entry, +1)
        self._publish_gauges()
        return evicted

    def _account(self, entry: CacheEntry, sign: int) -> None:
        self._total_bytes += sign * entry.nbytes
        for book, k in ((self._tenant_bytes, entry.tenant),
                        (self._label_bytes, entry.label)):
            n = book.get(k, 0) + sign * entry.nbytes
            if n <= 0:
                book.pop(k, None)
            else:
                book[k] = n
        # A fully-drained label publishes 0, never a stale sum (the
        # cache-HBM gauge's discipline).
        self.registry.gauge(
            "raft_tenant_cache_bytes",
            "response-cache bytes held per tenant label",
            tenant=entry.label).set(self._label_bytes.get(entry.label, 0))

    def _drop(self, key: Tuple) -> Optional[CacheEntry]:
        entry = self._table.pop(key, None)
        if entry is not None:
            self._account(entry, -1)
        return entry

    def _sweep(self, now: float) -> None:
        expired = [k for k, e in self._table.items()
                   if now - e.last_used > self.ttl_s]
        for k in expired:
            self._drop(k)
        if expired:
            self._c_expired.inc(len(expired))
            self._publish_gauges()

    def _make_room(self, entry: CacheEntry) -> List[CacheEntry]:
        """Own-LRU tenant eviction first (a tenant at its sub-cap must
        never displace another tenant's entries), then the global LRU.
        Returns the evicted entries (for counting + disk spill)."""
        evicted: List[CacheEntry] = []
        while self._tenant_bytes.get(entry.tenant, 0) + entry.nbytes \
                > self.per_tenant:
            victim = next((k for k, e in self._table.items()
                           if e.tenant == entry.tenant), None)
            if victim is None:
                break  # sub-cap below one entry: one scene still allowed
            evicted.append(self._drop(victim))
        while self._total_bytes + entry.nbytes > self.max_bytes \
                and self._table:
            victim = next(iter(self._table))
            evicted.append(self._drop(victim))
        return [e for e in evicted if e is not None]

    def _publish_gauges(self) -> None:
        self._g_bytes.set(self._total_bytes)
        self._g_entries.set(len(self._table))

    def _clear(self) -> int:
        n = len(self._table)
        for label in list(self._label_bytes):
            self.registry.gauge(
                "raft_tenant_cache_bytes",
                "response-cache bytes held per tenant label",
                tenant=label).set(0)
        self._table.clear()
        self._tenant_bytes.clear()
        self._label_bytes.clear()
        self._total_bytes = 0
        self._publish_gauges()
        return n

    # -- disk spill (RAFT_CACHE_DIR) ---------------------------------------

    #: Per-process monotonic suffix for spill temp files.  Two caches
    #: sharing one RAFT_CACHE_DIR (a fleet of instances, or two caches
    #: in one process) may spill the SAME key concurrently; a fixed
    #: "<path>.tmp" name would let writer B's open() truncate the file
    #: writer A is mid-np.savez on, and A's os.replace would then
    #: publish B's torn bytes under the final name.  pid + counter makes
    #: every tmp name unique, so each os.replace publishes only its own
    #: complete payload (last full write wins — both are valid entries
    #: for the same key).  Deliberately NOT ending in ".npz": the disk
    #: accounting scans and _prune_disk must never count or load an
    #: in-progress tmp.
    _TMP_SEQ = itertools.count()

    def _path_for(self, key: Tuple) -> str:
        name = hashlib.sha256(repr(key).encode()).hexdigest()
        return os.path.join(self.dir, f"{name}.npz")

    def _spill(self, entry: CacheEntry) -> None:
        """Persist one evicted exact-tier entry; bounded by the SAME
        byte budget again on disk (oldest-mtime pruning).  Spill
        failures disable nothing — the entry is simply gone, a miss."""
        path = self._path_for(entry.key)
        try:
            tmp = f"{path}.{os.getpid()}.{next(self._TMP_SEQ)}.tmp"
            payload: Dict[str, np.ndarray] = {
                "disparity": entry.disparity,
                "sig": entry.sig,
                "meta": np.frombuffer(json.dumps({
                    "key": repr(entry.key),
                    "iters": entry.iters,
                    "created": entry.created,
                    "padded_shape": (list(entry.padded_shape)
                                     if entry.padded_shape else None),
                }).encode(), dtype=np.uint8),
            }
            if entry.flow is not None:
                payload["flow"] = entry.flow
            # The spill write IS the cache's disk tier doing its job;
            # bounce-path deposits (watchdog resolving scheduled rows
            # under _check_lock) accept the bounded write — _check_lock
            # serializes sweeps only, never the serving path.
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)
        except OSError:
            logger.warning("cache spill to %s failed", path,
                           exc_info=True)
            return
        self._c_spills.inc()
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        with self._disk_lock:
            self._disk_account(size)
            self._prune_disk()

    def _disk_account(self, delta: int) -> None:
        # Caller holds self._disk_lock (the lock-held-helper discipline:
        # every _disk_bytes mutation lives here or in _prune_disk).
        self._disk_bytes = max(0, self._disk_bytes + delta)

    def _prune_disk(self) -> None:
        # Caller holds self._disk_lock.
        if self._disk_bytes <= self.max_bytes:
            return
        try:
            files = sorted(
                (e for e in os.scandir(self.dir)
                 if e.is_file() and e.name.endswith(".npz")),
                key=lambda e: e.stat().st_mtime)
        except OSError:
            return
        for e in files:
            if self._disk_bytes <= self.max_bytes:
                break
            try:
                size = e.stat().st_size
                os.unlink(e.path)
                self._disk_bytes -= size
            except OSError:
                continue

    def _disk_lookup(self, key: Tuple, tenant: str, label: str,
                     now: float) -> Optional[CacheEntry]:
        """RAM-miss fallback: load a spilled entry, verify its key and
        TTL, promote it back into RAM.  Any malformation is a miss."""
        path = self._path_for(key)
        try:
            if not os.path.exists(path):
                return None
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"]).decode())
                if meta.get("key") != repr(key):
                    return None  # hash collision / foreign file: a miss
                if now - float(meta.get("created", now)) > self.ttl_s:
                    size = os.path.getsize(path)
                    os.unlink(path)
                    with self._disk_lock:
                        self._disk_account(-size)
                    return None
                disparity = np.array(z["disparity"], dtype=np.float32)
                sig = np.array(z["sig"], dtype=np.float32)
                flow = (np.array(z["flow"], dtype=np.float32)
                        if "flow" in z.files else None)
                shape = meta.get("padded_shape")
        except Exception:  # noqa: BLE001 — a corrupt spill is a miss
            logger.warning("corrupt cache spill %s ignored", path,
                           exc_info=True)
            return None
        entry = CacheEntry(key, tenant, label, sig, disparity, flow,
                           tuple(shape) if shape else None,
                           int(meta.get("iters", 0)), now)
        entry.created = float(meta.get("created", now))
        if entry.nbytes > self.max_bytes:
            # Spilled under a larger budget than the current one (e.g. a
            # restart with a smaller --cache_bytes): serve this hit ONCE
            # but never promote — the RAM byte-budget invariant
            # (raft_cache_bytes <= RAFT_CACHE_BYTES) holds
            # unconditionally, the deposit path's oversize refusal
            # mirrored here.
            self._c_disk_hits.inc()
            return entry
        with self._lock:
            evicted = ([] if key in self._table
                       else self._store(entry))
        self._note_evictions(evicted)
        self._c_disk_hits.inc()
        return entry

    # -- lifecycle ---------------------------------------------------------

    def drop_all(self) -> int:
        """Service stop/drain: every RAM entry dies, gauges read 0.
        Disk spill survives deliberately — RAFT_CACHE_DIR exists to warm
        a RESTART, and the fingerprint folded into every key already
        guarantees a config-changed restart can never read a stale
        entry."""
        with self._lock:
            return self._clear()

    # -- reporting ---------------------------------------------------------

    def status(self) -> Dict:
        """The /healthz ``cache`` block — bounded by construction (the
        per-tenant byte map is summarized, never enumerated: entry
        counts are budget-bounded but tenant NAMES are attacker-chosen)."""
        with self._lock:
            entries = len(self._table)
            total = self._total_bytes
            tenants = len(self._tenant_bytes)
        hits = int(self._c_hits.value)
        misses = int(self._c_misses.value)
        doc = {
            "enabled": self.enabled,
            "max_bytes": self.max_bytes,
            "per_tenant_bytes": self.per_tenant,
            "ttl_ms": self.ttl_s * 1e3,
            "near_tol": self.near_tol,
            "entries": entries,
            "bytes": total,
            "tenants": tenants,
            "hits": hits,
            "misses": misses,
            "near_hits": int(self._c_near.value),
            "hit_ratio": (hits / (hits + misses)
                          if hits + misses else None),
            "evictions": int(self._c_evicted.value),
            "expired": int(self._c_expired.value),
            "deposits": int(self._c_deposits.value),
            "deposits_refused": int(self._c_refused.value),
        }
        if self.dir:
            with self._disk_lock:
                doc["disk"] = {"dir": self.dir,
                               "bytes": self._disk_bytes,
                               "spills": int(self._c_spills.value),
                               "hits": int(self._c_disk_hits.value)}
        return doc
