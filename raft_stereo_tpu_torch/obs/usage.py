"""Per-tenant usage accounting — who is spending the device?

A copy of the JAX package's ``obs/usage.py``.

The HTTP ingress already keys admission quotas by a sanitized
``X-Raft-Tenant`` header; this module joins that same key through
admission into the scheduler rows and accumulates, per tenant:

- **requests by outcome** (the same outcome keys
  ``raft_requests_total`` uses, so the two series reconcile);
- **device seconds** — every steady (non-warming) device invocation's
  device time, partitioned EXACTLY among the rows riding the batch.
  Exactness is the load-bearing property (it is what makes per-tenant
  billing honest and the ROADMAP item 4 tier policy enforceable), so
  the ledger is kept in integer NANOSECONDS: one invocation's
  ``round(device_s * 1e9)`` is split with :func:`partition_ints`, whose
  shares sum to the total by construction — the chaos soak pins
  ``sum(per-tenant ns) == accounted-total ns`` as an integer equality,
  and the accounted total reconciles with
  ``raft_program_device_seconds_total`` at float tolerance;
- **ledger flops** (the program's per-invocation estimate, same exact
  integer partition) and **bytes in/out** on the wire (the ingress
  accounts request-body and response-body bytes).

Label discipline mirrors the ingress quota buckets exactly: the first
``max_tenants`` distinct names keep their own label, every later name
shares ``__other__`` — the metrics registry keeps every (name, labels)
instrument forever, so hostile tenant-name churn must be bounded HERE
(regression-pinned: churn past the bound cannot grow ``/metrics``).

Stdlib-only, no jax; the registry is injected.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

SCHEMA = 1

#: Mirrors serve/http.py TenantQuotas: bounded label cardinality.
DEFAULT_MAX_TENANTS = 1024
OVERFLOW_LABEL = "__other__"

#: Requests that arrive with no tenant at all (in-process callers, the
#: CLI batch runner) — the same fallback the quota key uses.
DEFAULT_TENANT = "default"


def sanitize_tenant(raw: Optional[str], max_len: int = 64) -> str:
    """A hostile header value becomes a bounded, label-safe tenant key:
    [A-Za-z0-9._-] kept, everything else mapped to ``_``, capped at
    ``max_len``; empty/absent is the ``default`` tenant.  Deterministic,
    so quota accounting, usage accounting and metric labels all agree on
    the key (this is the ONE implementation — serve/http.py imports it)."""
    if not raw:
        return DEFAULT_TENANT
    out = "".join(c if (c.isalnum() or c in "._-") else "_"
                  for c in raw[:max_len])
    return out or DEFAULT_TENANT


def partition_ints(total: int, n: int) -> List[int]:
    """Split ``total`` into ``n`` integer shares that sum to ``total``
    EXACTLY (the first ``total % n`` shares carry the remainder unit).
    This is what keeps per-tenant device time an exact partition of the
    program total — float division would leak ulps on every tick."""
    if n < 1:
        raise ValueError(f"cannot partition across {n} riders")
    base, rem = divmod(int(total), n)
    return [base + 1] * rem + [base] * (n - rem)


class _TenantRow:
    """Mutable per-tenant account; all fields integer or plain dict,
    mutated only under the accountant's lock."""

    __slots__ = ("device_ns", "flops", "bytes_in", "bytes_out", "outcomes",
                 "warm_joins", "converged", "cache_hits",
                 "cache_near_hits", "cache_misses")

    def __init__(self):
        self.device_ns = 0
        self.flops = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.outcomes: Dict[str, int] = {}
        # graftstream (serve/stream.py): frames that warm-started and
        # rows that exited through the convergence monitor — the
        # /debug/usage view of who is actually getting the streaming
        # speedup.
        self.warm_joins = 0
        self.converged = 0
        # graftrecall (serve/cache.py): exact hits, near-tier warm
        # seeds and misses — the /debug/usage view of who is actually
        # getting the zero-device-seconds win.
        self.cache_hits = 0
        self.cache_near_hits = 0
        self.cache_misses = 0


class UsageAccountant:
    """Bounded per-tenant usage ledger + its registry mirror.

    The integer ledger here is the exactness truth (/debug/usage reads
    it); the ``raft_tenant_*`` Prometheus series mirror it in float for
    scrapes.  One accountant per serving process, owned by the session
    (like the registry), shared by service, scheduler and ingress.
    """

    def __init__(self, registry, max_tenants: int = DEFAULT_MAX_TENANTS):
        self.registry = registry
        self.max_tenants = max_tenants
        self._lock = threading.Lock()
        self._labels: set = set()
        self._rows: Dict[str, _TenantRow] = {}
        self._device_ns_total = 0
        self._flops_total = 0

    # -- label discipline --------------------------------------------------

    def label(self, tenant: Optional[str]) -> str:
        """Metric-safe tenant label under the first-come bound: the
        (sanitized) name itself while the label set has room, the shared
        ``__other__`` after — same discipline as the quota buckets."""
        tenant = sanitize_tenant(tenant)
        with self._lock:
            if tenant in self._labels:
                return tenant
            if len(self._labels) < self.max_tenants:
                self._labels.add(tenant)
                return tenant
            return OVERFLOW_LABEL

    def _row(self, label: str) -> _TenantRow:
        # Caller holds self._lock; label has already passed label().
        row = self._rows.get(label)
        if row is None:
            row = self._rows[label] = _TenantRow()
        return row

    # -- accounting --------------------------------------------------------

    def count_request(self, label: str, outcome: str) -> None:
        """One resolved request outcome (the same key the service counts
        into ``raft_requests_total``), attributed to its tenant."""
        with self._lock:
            row = self._row(label)
            row.outcomes[outcome] = row.outcomes.get(outcome, 0) + 1
        self.registry.counter(
            "raft_tenant_requests_total",
            "request outcomes by tenant (first-come-bounded labels)",
            tenant=label, outcome=outcome).inc()

    def add_device(self, labels: Sequence[str], device_s: float,
                   flops: Optional[float] = None) -> None:
        """One steady device invocation, partitioned exactly among the
        rows that rode it.  ``labels`` may repeat (two rows of one
        tenant in a batch) — shares accumulate, the integer sum stays
        exact."""
        if not labels or device_s < 0:
            return
        total_ns = int(round(device_s * 1e9))
        shares = partition_ints(total_ns, len(labels))
        flop_shares = (partition_ints(int(round(flops)), len(labels))
                       if flops else None)
        with self._lock:
            self._device_ns_total += total_ns
            if flop_shares is not None:
                self._flops_total += int(round(flops))
            for i, label in enumerate(labels):
                row = self._row(label)
                row.device_ns += shares[i]
                if flop_shares is not None:
                    row.flops += flop_shares[i]
        for i, label in enumerate(labels):
            self.registry.counter(
                "raft_tenant_device_seconds_total",
                "steady device seconds attributed to tenants (exact "
                "integer-ns partition across batch rows)",
                tenant=label).inc(shares[i] / 1e9)
            if flop_shares is not None and flop_shares[i]:
                self.registry.counter(
                    "raft_tenant_flops_total",
                    "ledger-estimated flops attributed to tenants",
                    tenant=label).inc(flop_shares[i])

    def note_stream(self, label: str, warm_join: bool = False,
                    converged: bool = False) -> None:
        """graftstream accounting: one warm join and/or one converged
        exit for this tenant.  Counted where the event actually happens
        (the scheduler's warm prepare, the convergence exit decision) —
        the per-tenant twin of the global ``raft_stream_*`` counters, so
        /debug/usage can answer "who is getting the streaming win"."""
        if not (warm_join or converged):
            return
        with self._lock:
            row = self._row(label)
            if warm_join:
                row.warm_joins += 1
            if converged:
                row.converged += 1
        if warm_join:
            self.registry.counter(
                "raft_tenant_stream_warm_joins_total",
                "warm-started frames by tenant", tenant=label).inc()
        if converged:
            self.registry.counter(
                "raft_tenant_stream_converged_total",
                "convergence early exits by tenant", tenant=label).inc()

    def note_cache(self, label: str, exact: bool = False,
                   near: bool = False, miss: bool = False) -> None:
        """graftrecall accounting (serve/cache.py): one exact hit, one
        near-tier warm seed, or one miss for this tenant.  Counted where
        the cache decision actually lands (ResponseCache.admit) — the
        per-tenant twin of the global ``raft_cache_*`` counters, so
        /debug/usage can answer "who is getting the cache win"."""
        if not (exact or near or miss):
            return
        with self._lock:
            row = self._row(label)
            if exact:
                row.cache_hits += 1
            if near:
                row.cache_near_hits += 1
            if miss:
                row.cache_misses += 1
        if exact:
            self.registry.counter(
                "raft_tenant_cache_hits_total",
                "exact-tier response-cache hits by tenant",
                tenant=label).inc()
        if near:
            self.registry.counter(
                "raft_tenant_cache_near_hits_total",
                "near-tier warm-start seeds by tenant",
                tenant=label).inc()
        if miss:
            self.registry.counter(
                "raft_tenant_cache_misses_total",
                "response-cache misses by tenant", tenant=label).inc()

    def add_bytes(self, label: str, n_in: int = 0, n_out: int = 0) -> None:
        """Wire bytes for one request (the ingress accounts these; the
        in-process paths have no wire bytes and account nothing)."""
        with self._lock:
            row = self._row(label)
            row.bytes_in += int(n_in)
            row.bytes_out += int(n_out)
        if n_in:
            self.registry.counter(
                "raft_tenant_bytes_in_total",
                "request body bytes read off the wire by tenant",
                tenant=label).inc(int(n_in))
        if n_out:
            self.registry.counter(
                "raft_tenant_bytes_out_total",
                "response body bytes written to the wire by tenant",
                tenant=label).inc(int(n_out))

    # -- reporting ---------------------------------------------------------

    @property
    def device_ns_total(self) -> int:
        with self._lock:
            return self._device_ns_total

    def doc(self) -> Dict:
        """The /debug/usage rollup: bounded (max_tenants + overflow),
        sorted by device time descending, integer-exact."""
        with self._lock:
            rows = {label: {
                "device_ns": r.device_ns,
                "device_s": r.device_ns / 1e9,
                "flops": r.flops,
                "bytes_in": r.bytes_in,
                "bytes_out": r.bytes_out,
                "requests": dict(sorted(r.outcomes.items())),
                "stream": {"warm_joins": r.warm_joins,
                           "converged_exits": r.converged},
                "cache": {"hits": r.cache_hits,
                          "near_hits": r.cache_near_hits,
                          "misses": r.cache_misses},
            } for label, r in self._rows.items()}
            total_ns = self._device_ns_total
            flops_total = self._flops_total
            n_labels = len(self._labels)
        ordered = dict(sorted(rows.items(),
                              key=lambda kv: (-kv[1]["device_ns"], kv[0])))
        return {"schema": SCHEMA,
                "max_tenants": self.max_tenants,
                "tenants_tracked": n_labels,
                "overflow_active": OVERFLOW_LABEL in rows,
                "device_ns_total": total_ns,
                "device_seconds_total": total_ns / 1e9,
                "flops_total": flops_total,
                "by_tenant": ordered}

    def status(self) -> Dict:
        """The small /healthz summary (the full rollup is /debug/usage)."""
        with self._lock:
            return {"tenants_tracked": len(self._labels),
                    "max_tenants": self.max_tenants,
                    "device_seconds_total": self._device_ns_total / 1e9}
