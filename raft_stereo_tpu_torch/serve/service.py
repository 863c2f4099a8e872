"""Stdlib-only request service over an InferenceSession.

The port's counterpart of the JAX package's ``serve/service.py``: the same
queue, admission, deadlines, responses, counters, supervision and /healthz
document, with the video streams (``serve/stream.py``: a request's
``stream`` id warm-starts it from its previous frame, ``converge_tol`` arms
the convergence exit) and the response cache (``serve/cache.py``: an exact
repeat is answered before admission with no device work, a near repeat is
seeded from its neighbor). Stream members take the segmented path:
``stream_infer`` on the workers, the scheduler's warm rows in batched
mode. The stream deposit and the cache deposit happen before a request's
Future resolves.

Queueing discipline for a latency-bound model server, with nothing but
``threading`` + ``queue``:

- **bounded depth + explicit backpressure**: a full queue rejects the
  request *immediately* (``queue_full``) instead of stretching every
  caller's latency without bound;
- **admission control at submit time**: malformed inputs (validate.py)
  never occupy a queue slot or a device;
- **per-request deadlines**: requests that expire while queued are
  rejected on dequeue without touching the device; live ones carry their
  absolute deadline into the session's degrade policy;
- **crash-proof workers**: a worker turns *any* session failure into a
  structured error response — one poisoned request cannot take the
  process down (fault-storm-pinned in tests/test_serve.py);
- **continuous batching** (``SessionConfig.max_batch > 1``): the worker
  pool is replaced by ONE scheduler thread driving
  :class:`~raft_stereo_tpu_torch.serve.scheduler.BatchScheduler`, its
  programs CUDA graphs on the card — requests
  join a running device batch at tick boundaries and exit at segment
  boundaries. The queue, admission, backpressure (``queue_full``) and
  response contract are IDENTICAL to the sequential path;
- **/healthz**: ``status()`` folds session state (bucket cache, breaker
  trips, canary), queue depth, request counters by rejection/error code,
  degraded-request count, p50/p99 latency over a sliding window, and — in
  batched mode — the ``batching`` document (per-tick occupancy histogram,
  joins/exits per tick, pad-row waste, tick latency percentiles: the
  numbers that tune ``--max_batch`` in production).

Every response is a plain dict: ``{"status": "ok" | "rejected" |
"error", ...}`` — ``ok`` always carries a finite disparity and an honest
``quality`` label.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Dict, Optional

import logging

from raft_stereo_tpu_torch.obs.tracing import NULL_TRACE
from raft_stereo_tpu_torch.obs.usage import sanitize_tenant
from raft_stereo_tpu_torch.serve.session import (DeadlineExceeded, InferenceSession,
                                           SessionError)
from raft_stereo_tpu_torch.serve.supervise import (Heartbeat, Supervisor,
                                             WatchdogTrip, drain_deadline,
                                             drain_expired,
                                             resolve_drain_grace_ms,
                                             resolve_retry_budget,
                                             resolve_watchdog_ms)
from raft_stereo_tpu_torch.serve.validate import InputRejected, validate_pair

logger = logging.getLogger(__name__)

#: Response codes the retry budget may re-admit (graftguard, DESIGN.md
#: r13).  Everything else is deterministic — validation failures,
#: internal invariants — and fails fast.  ``nonfinite_output`` is
#: special-cased: retried at most once (the issue contract: a second
#: non-finite output is a deterministic failure, not noise).
TRANSIENT_CODES = frozenset({
    "upload_failed",         # uploader thread death (bounce brings a new one)
    "device_hang",           # watchdog-detected hung invocation
    "scheduler_restarted",   # generation bounce (tick crash/stall)
    "nonfinite_output",      # possibly-transient poisoned output (once)
})


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    max_queue: int = 8
    workers: int = 1
    # Applied when a request carries no deadline_ms of its own; None means
    # undegraded full-iteration serving by default.
    default_deadline_ms: Optional[float] = None
    latency_window: int = 512
    # Scheduler idle poll (continuous batching only): how long the
    # scheduler thread blocks for new work when every bucket is empty.
    # None reads RAFT_SCHED_TICK_MS at start() (default 2 ms). Purely a
    # host-side latency/CPU trade — it never shapes a compiled program.
    tick_ms: Optional[float] = None
    # SLO flight recorder (obs/flight.py): a served request whose
    # end-to-end latency exceeds slo_ms * slo_factor — or any request
    # that tripped a breaker rung, missed its deadline or produced a
    # non-finite output — persists a bounded flight record to
    # RAFT_FLIGHT_DIR. slo_ms=None disables the latency criterion only;
    # the other breach classes always record when the recorder is armed.
    slo_ms: Optional[float] = None
    slo_factor: float = 1.0
    # graftguard (serve/supervise.py). All three resolve at construction:
    # explicit value > env knob > default — host-side serving behavior
    # only, never part of any program fingerprint (analysis/knobs.py
    # SERVE_ENV_KNOBS).
    #
    # retry_budget: bounded re-admissions per request for TRANSIENT
    # failures (upload_failed / generation bounce / a first non-finite
    # output), original deadline honored, count surfaced as
    # ``retries: k`` on the response. None -> RAFT_RETRY_BUDGET -> 2.
    retry_budget: Optional[int] = None
    # watchdog_ms: hang-deadline floor for the invocation watchdog and
    # heartbeat staleness. None -> RAFT_WATCHDOG_MS -> 0 = supervision
    # disarmed (the library default; serve_stereo.py defaults it ON).
    watchdog_ms: Optional[float] = None
    # drain_grace_ms: graceful-drain hard deadline (real time) before
    # remaining Futures resolve service_stopped.
    # None -> RAFT_DRAIN_GRACE_MS -> 10 s.
    drain_grace_ms: Optional[float] = None
    # supervise: run the watchdog monitor thread (batched mode with a
    # positive watchdog floor only). check_now() remains drivable by
    # hand either way.
    supervise: bool = True
    # Streams (serve/stream.py). All three resolve at construction:
    # explicit value > env knob > default — host-side session-table sizing
    # and a host-side norm comparison, never part of any program
    # fingerprint (analysis/knobs.py HOST_ENV_KNOBS).
    #
    # stream_sessions: global bound on live stream sessions (LRU).
    # None -> RAFT_STREAM_SESSIONS -> 128.
    stream_sessions: Optional[int] = None
    # stream_ttl_ms: idle-session expiry on the session clock.
    # None -> RAFT_STREAM_TTL_MS -> 60 s.
    stream_ttl_ms: Optional[float] = None
    # converge_tol: default convergence tolerance stamped on warm frames
    # (px/iter segment-mean |delta_x| at 1/8 res; 0 disables).
    # None -> RAFT_CONVERGE_TOL -> 0.01.
    converge_tol: Optional[float] = None
    # The response cache (serve/cache.py). All four resolve at
    # construction: explicit value > env knob > default — a host-side
    # store, never part of any program fingerprint (the fingerprint is
    # folded INTO every cache key instead).
    #
    # cache_bytes: host-RAM budget of the cache. None -> RAFT_CACHE_BYTES
    # -> 0 = disabled (the library default; the serving CLI defaults it
    # on at 256 MiB).
    cache_bytes: Optional[int] = None
    # cache_ttl_ms: entry expiry on the session clock.
    # None -> RAFT_CACHE_TTL_MS -> 10 min.
    cache_ttl_ms: Optional[float] = None
    # cache_near_tol: near-tier block-mean signature threshold (gray
    # levels; 0 = near tier off). None -> RAFT_CACHE_NEAR_TOL -> 0.
    cache_near_tol: Optional[float] = None
    # cache_dir: optional disk spill for evicted exact-tier entries.
    # None -> RAFT_CACHE_DIR -> RAM only.
    cache_dir: Optional[str] = None


def _reject(code: str, message: str) -> Dict:
    return {"status": "rejected", "code": code, "message": message}


def _error(code: str, message: str) -> Dict:
    return {"status": "error", "code": code, "message": message}


class StereoService:
    """Request queue + worker pool around one :class:`InferenceSession`."""

    def __init__(self, session: InferenceSession,
                 service_cfg: Optional[ServiceConfig] = None):
        self.session = session
        self.cfg = service_cfg or ServiceConfig()
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.cfg.max_queue)
        self._workers = []
        self._stop = threading.Event()
        # graftscope: request counters and the latency reservoir live in
        # the session's ONE registry (shared with the scheduler), so
        # /healthz is derivable from /metrics byte-for-byte — no service-
        # private Counter/deque to fold in.
        self.registry = session.registry
        self.tracer = session.tracer
        self.profiler = session.profiler
        self._latency = self.registry.histogram(
            "raft_request_latency_seconds",
            "end-to-end served-request latency (bounded reservoir)",
            reservoir=self.cfg.latency_window)
        self._gauge_depth = self.registry.gauge(
            "raft_queue_depth", "requests currently queued (bounded by "
            "max_queue)")
        self._lock = threading.Lock()
        self._started = False
        # graftfleet: /healthz carries generation identity + age at the
        # top level so a fleet router can detect deploy-generation
        # membership and restarts from the ONE endpoint it already
        # polls (fingerprint otherwise lives only on /debug/config).
        self._born = self.session.clock.now()
        # graftguard (serve/supervise.py): generation counter, drain
        # flag, retry budget, watchdog config. The scheduler generation
        # is bounced (fresh scheduler + thread, rows re-admitted) by the
        # supervisor on a watchdog trip; _zombies keeps retired threads
        # joinable at stop().
        self._draining = False
        self._generation = 0
        self._zombies: list = []
        self._heartbeat: Optional[Heartbeat] = None
        self._supervisor: Optional[Supervisor] = None
        self._inflight = 0   # sequential-mode requests between dequeue
        #                      and resolution (drain quiescence check)
        # Futures admitted by submit() and not yet resolved. Queue depth
        # + scheduler state alone cannot prove quiescence: a row lives in
        # NEITHER for the instant between a consumer's dequeue and its
        # adoption (sched.submit / the worker's _inflight increment), so
        # a _quiesced() poll in that window would report a clean drain
        # with work still in flight. This counter spans the whole life of
        # an admitted Future — incremented under the enqueue lock, decre-
        # mented exactly once at resolution (_claim guards the batched
        # paths; a worker-mode item has exactly one consumer).
        self._outstanding = 0
        self._retry_budget = resolve_retry_budget(self.cfg.retry_budget)
        self._watchdog_s = resolve_watchdog_ms(self.cfg.watchdog_ms) / 1e3
        self._drain_grace_s = resolve_drain_grace_ms(
            self.cfg.drain_grace_ms) / 1e3
        # Continuous batching engages when the SESSION was built for it
        # (max_batch shapes compiled programs and warmup, so it lives on
        # SessionConfig); the service then runs one scheduler thread
        # instead of the worker pool. The scheduler itself is built per
        # START generation (like the stop event): stop() permanently ends
        # its uploader thread and drains its state, so reusing one across
        # a restart would hang every post-restart request in the join
        # queue.
        self._batched = session.cfg.max_batch > 1
        self._scheduler = None
        # The bounded stream-session table and its warm-start and
        # convergence stamping (serve/stream.py): always constructed (no
        # session when no client streams); the serving paths count warm
        # joins and converged exits through it, and the response hooks
        # deposit each served frame's low-res flow BEFORE the Future
        # resolves.
        from raft_stereo_tpu_torch.serve.stream import StreamManager
        self.stream = StreamManager(
            session, max_sessions=self.cfg.stream_sessions,
            ttl_ms=self.cfg.stream_ttl_ms, converge_tol=self.cfg.converge_tol)
        # The two-tier response cache (serve/cache.py): always constructed
        # (no state when disabled); admission consults it after
        # validation, response resolution deposits into it BEFORE the
        # Future resolves. The stream's tolerance is its warm-exit default,
        # so both warm-start flavors exit by one rule.
        from raft_stereo_tpu_torch.serve.cache import ResponseCache
        self.cache = ResponseCache(
            session, max_bytes=self.cfg.cache_bytes, ttl_ms=self.cfg.cache_ttl_ms,
            near_tol=self.cfg.cache_near_tol, cache_dir=self.cfg.cache_dir,
            default_converge_tol=self.stream.converge_tol)

    # -- lifecycle --------------------------------------------------------

    def _tick_s(self) -> float:
        import os
        tick_ms = self.cfg.tick_ms
        if tick_ms is None:
            tick_ms = float(os.environ.get("RAFT_SCHED_TICK_MS", "2"))
        return tick_ms / 1e3

    def _spawn_scheduler_thread(self, sched, stop_event, hb) -> threading.Thread:
        t = threading.Thread(target=self._scheduler_loop,
                             args=(sched, stop_event, self._tick_s(), hb),
                             name=f"stereo-scheduler-g{self._generation}",
                             daemon=True)
        t.start()
        return t

    def start(self) -> "StereoService":
        with self._lock:
            if self._started:
                return self
            self._started = True
            self._draining = False
            self._generation += 1
            # Fresh event per generation: a worker that outlives a timed-out
            # join (e.g. mid-compile on a cold bucket) still holds its OWN
            # generation's set event and exits when its request finishes —
            # it can never be revived as an untracked extra worker.
            self._stop = threading.Event()
            stop_event = self._stop
            if self._batched:
                from raft_stereo_tpu_torch.serve.scheduler import BatchScheduler
                # Fresh scheduler per generation; a previous generation's
                # thread (possibly still ticking its own active rows out
                # past the join timeout) holds only its OWN scheduler and,
                # once its stop event is set, never touches the shared
                # queue again — two generations can never race on one
                # batch state.
                self._scheduler = BatchScheduler(
                    self.session, resolve=self._resolve_scheduled,
                    retry=self._retry_scheduled,
                    generation=self._generation, stream=self.stream,
                    cache=self.cache)
                self._heartbeat = Heartbeat("scheduler", self.session.clock)
                sched, hb = self._scheduler, self._heartbeat
                # Spawn + publish INSIDE the lock — the same invariant
                # _bounce() enforces: supervised_state() reads scheduler/
                # heartbeat/_stop/_workers under this lock, so a
                # concurrent check_now() can never observe started=True
                # with no live worker and stopping=False — a gap it
                # would misread as tick_crashed and bounce the brand-new
                # generation before its thread was even published.
                self._workers.append(
                    self._spawn_scheduler_thread(sched, stop_event, hb))
        if self._batched:
            # The watchdog monitor: armed only with a positive floor —
            # RAFT_WATCHDOG_MS=0 (the library default) leaves supervision
            # off so FakeClock test rigs never race a real-time poll.
            if self.cfg.supervise and self._watchdog_s > 0:
                if self._supervisor is None:
                    self._supervisor = Supervisor(
                        self, watchdog_s=self._watchdog_s)
                self._supervisor.start()
            return self
        for i in range(self.cfg.workers):
            t = threading.Thread(target=self._worker_loop,
                                 args=(stop_event,),
                                 name=f"stereo-worker-{i}", daemon=True)
            t.start()
            with self._lock:
                self._workers.append(t)
        return self

    def stop(self) -> None:
        sup = self._supervisor
        if sup is not None:
            sup.stop()
        with self._lock:
            # Flip first, under the same lock submit() enqueues under: any
            # submit that saw started=True has already enqueued, so the
            # drain below provably sees it; later submits are rejected.
            self._started = False
            self._stop.set()
        for _ in self._workers:
            try:
                self._queue.put_nowait(None)  # wake sentinel
            except queue.Full:
                break  # queue backlog itself will wake the workers
        for t in self._workers:
            t.join(timeout=10)
        # Resolve every still-queued Future with a structured rejection —
        # an abandoned Future deadlocks any caller blocked on .result().
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            request, fut = item
            self._force_resolve(request, fut, drain_event=True)
        self._gauge_depth.set(self._queue.qsize())
        with self._lock:
            self._workers = [t for t in self._workers if t.is_alive()]
        # Zombie threads (generations retired by a bounce whose join
        # timed out — e.g. wedged in a real device hang) are joined LAST:
        # they never touch the shared queue once defunct, so waiting on
        # them before the drain above would only delay force-resolution
        # of every queued Future by the join timeout per leaked thread.
        # One SHARED deadline across all of them: k wedged generations
        # must not cost k x 5 s of shutdown latency.
        import time as _time
        deadline = _time.monotonic() + 5.0
        for t in self._zombies:
            t.join(timeout=max(0.0, deadline - _time.monotonic()))
        self._zombies = [t for t in self._zombies if t.is_alive()]
        # Stream sessions die with the service: a restart serves cold first
        # frames, a held flow never outlives the generation that made it.
        dropped = self.stream.drop_all()
        if dropped:
            logger.info("dropped %d stream session(s) on stop", dropped)
        # So do the cache's RAM entries (the RAFT_CACHE_DIR spill persists
        # on purpose; its keys hold the fingerprint, so a restart under
        # another configuration cannot read them).
        dropped = self.cache.drop_all()
        if dropped:
            logger.info("dropped %d cached response(s) on stop", dropped)

    # -- graceful drain (graftguard, DESIGN.md r13) ------------------------

    def begin_drain(self) -> None:
        """Flip into draining: new submits are rejected
        ``service_draining``; everything already admitted keeps running
        to its segment-boundary exit. Idempotent and non-blocking (a
        signal-driven caller flips this, then keeps consuming its
        in-flight Futures)."""
        with self._lock:
            if self._draining or not self._started:
                return
            self._draining = True
            sched = self._scheduler
        logger.info("service draining: new submits rejected "
                    "service_draining; admitted rows run to their exits")
        if sched is not None:
            for request in sched.inflight_requests():
                trace = request.get("_trace")
                if trace is not None:
                    trace.event("drain", action="run_to_exit")

    def drain(self, grace_s: Optional[float] = None) -> bool:
        """Graceful shutdown: reject new work, run everything admitted to
        its exit, then stop. Returns True when the service quiesced
        within the grace window (real time — drain is an operational
        action); on timeout, stop() force-resolves the remainder
        ``service_stopped`` so no Future is ever abandoned."""
        import time as _time
        self.begin_drain()
        deadline = drain_deadline(self._drain_grace_s
                                  if grace_s is None else grace_s)
        clean = False
        while not drain_expired(deadline):
            if self._quiesced():
                clean = True
                break
            _time.sleep(0.01)
        if not clean:
            logger.warning(
                "drain grace expired with work in flight — remaining "
                "Futures resolve service_stopped")
        self.stop()
        return clean

    def _quiesced(self) -> bool:
        with self._lock:
            # _outstanding spans an admitted Future's whole life, so the
            # dequeued-but-not-yet-adopted instant (invisible to both the
            # queue and the scheduler/_inflight) cannot read as quiesced.
            if self._outstanding or self._inflight:
                return False
            sched = self._scheduler if self._batched else None
        if not self._queue.empty():
            return False
        return sched is None or not (sched.active_rows > 0 or sched.has_work)

    def __enter__(self) -> "StereoService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path -----------------------------------------------------

    def _count(self, outcome: str) -> None:
        """One request outcome into the registry (same keys /healthz has
        always reported: 'ok', 'rejected:<code>', 'error:<code>',
        'degraded')."""
        self.registry.counter(
            "raft_requests_total", "request outcomes by disposition",
            outcome=outcome).inc()

    def _tenant_label(self, request: Dict) -> str:
        """Bounded usage label for one request's tenant (the ingress
        stamps ``request['tenant']`` with the sanitized header key;
        in-process callers default to 'default')."""
        return self.session.usage.label(
            sanitize_tenant(request.get("tenant")))

    def _count_outcome(self, request: Dict, outcome: str) -> None:
        """One request outcome into BOTH series: the service-wide
        ``raft_requests_total`` and the per-tenant usage account
        (obs/usage.py) — same outcome key, so the two reconcile."""
        self._count(outcome)
        self.session.usage.count_request(self._tenant_label(request),
                                         outcome)

    @staticmethod
    def _finish_trace(request: Dict, resp: Dict) -> None:
        trace = request.get("_trace")
        if trace is not None:
            trace.finish(status=resp["status"], code=resp.get("code"),
                         quality=resp.get("quality"))

    # -- SLO flight recorder ----------------------------------------------

    def _breach_reasons(self, resp: Dict, spans) -> list:
        """Why this response is an SLO breach (empty = healthy). The
        latency criterion needs an explicit slo_ms; breaker trips,
        missed deadlines and non-finite outputs always count."""
        reasons = []
        if resp.get("code") == "nonfinite_output":
            reasons.append("nonfinite_output")
        if any(s.kind == "breaker_trip" for s in spans):
            reasons.append("breaker_trip")
        # Served-but-late (degrade sets deadline_missed) AND rejected-as-
        # expired (deadline_exceeded / deadline_exceeded_in_queue) both
        # count: the queue-backlog rejection is exactly the case whose
        # queue_wait timeline an operator needs most.
        if resp.get("deadline_missed") or \
                str(resp.get("code", "")).startswith("deadline_exceeded"):
            reasons.append("deadline_missed")
        elapsed = resp.get("elapsed_ms")
        if (self.cfg.slo_ms is not None and elapsed is not None
                and elapsed > self.cfg.slo_ms * self.cfg.slo_factor):
            reasons.append("latency_slo")
        return reasons

    def _maybe_flight(self, request: Dict, resp: Dict) -> None:
        """Persist a flight record when this (already trace-finished)
        response breached its SLO. Runs on the response-resolution path
        for BOTH serving modes, so it must never raise — the recorder is
        failure-isolated, and this wrapper only reads local state."""
        flight = self.session.flight
        if not flight.enabled:
            return
        trace = request.get("_trace")
        spans = getattr(trace, "spans", None) or []
        reasons = self._breach_reasons(resp, spans)
        if not reasons:
            return
        # Ledger rows of every program the request actually rode: spans
        # carry the program's ledger id (session.invoke / the scheduler
        # stamp them), and the ledger is bounded by the LRU cache size.
        ids = {s.attrs.get("program") for s in spans
               if s.attrs.get("program")}
        # Tick-seq range (obs/deck.py): device spans carry the flight-
        # deck seq of the tick they rode, so the post-mortem names the
        # exact ticks to pull from GET /debug/ticks.
        tick_seqs = sorted({s.attrs.get("tick") for s in spans
                            if s.attrs.get("tick") is not None})
        doc = {
            "schema": 1,
            "ticks": ({"first": tick_seqs[0], "last": tick_seqs[-1],
                       "count": len(tick_seqs)} if tick_seqs else None),
            "reasons": reasons,
            "slo_ms": self.cfg.slo_ms,
            "slo_factor": self.cfg.slo_factor,
            "response": {k: resp.get(k) for k in
                         ("id", "status", "code", "quality", "iters",
                          "elapsed_ms", "deadline_missed")},
            "trace": (trace.to_dict()
                      if trace is not None and trace is not NULL_TRACE
                      else None),
            "programs": self.session.ledger.rows_by_id(ids),
            "breaker": self.session.breaker.status(),
            "metrics": self.registry.snapshot(),
        }
        flight.record(doc, trace_id=getattr(trace, "trace_id", None))

    def _admit(self, request: Dict) -> Optional[Dict]:
        """Validation + deadline stamping; returns a rejection dict or
        None. Mutates ``request``: a trace is opened (trace id at
        admission), the absolute ``_deadline`` is stamped and left/right
        are replaced with their validated canonical form, so the session
        skips a second O(N) validation pass on dequeue."""
        trace = request.get("_trace")
        if trace is None:
            trace = self.tracer.start_request(request.get("id"))
            request["_trace"] = trace
        try:
            with trace.span("validate"):
                request["left"], request["right"] = validate_pair(
                    request["left"], request["right"],
                    self.session.cfg.admission)
        except InputRejected as e:
            trace.mark("admission", rejected=e.code)
            return _reject(f"invalid_input:{e.code}", str(e))
        except KeyError as e:
            trace.mark("admission", rejected="missing_field")
            return _reject("invalid_input:missing_field",
                           f"request missing {e}")
        deadline_ms = request.get("deadline_ms",
                                  self.cfg.default_deadline_ms)
        request["_deadline"] = (
            None if deadline_ms is None
            else self.session.clock.now() + deadline_ms / 1e3)
        # Resolve the stream session (if any) and stamp the warm seed and
        # the tolerance onto the request dict, where a generation bounce's
        # re-admission finds them (a bounced stream frame stays warm).
        self.stream.admit(request)
        trace.mark("admission", h=int(request["left"].shape[1]),
                   w=int(request["left"].shape[2]),
                   deadline_ms=deadline_ms,
                   warm=request.get("_flow_init") is not None)
        return None

    def _serve_cache_hit(self, request: Dict, resp: Dict) -> Dict:
        """Finalize one exact-tier cache hit: the stream deposit first (the
        entry's held low-res flow keeps a stream warm across a hit), then
        the resolution tail (id, counters, trace). No invoke, no tick, no
        program counter, no usage nanosecond moves."""
        flow = request.pop("_cache_stream_flow", None)
        if flow is not None:
            request["_stream_flow"] = flow
            request["_stream_shape"] = request.pop("_cache_stream_shape", None)
        self.stream.deposit(request, resp)
        if request.get("id") is not None:
            resp["id"] = request["id"]
        # A label other than full counts in `degraded` (cache:exact is the
        # full-quality answer; the counter's rule is mechanical).
        if resp.get("quality") != "full":
            self._count("degraded")
        self._count_outcome(request, "ok")
        self._finish_trace(request, resp)
        return resp

    def _respond_once(self, request: Dict) -> Dict:
        """One serving attempt, synchronously, never raising — no
        counters, no trace finishing (the retry loop in ``_respond``
        owns those)."""
        trace = request.get("_trace") or NULL_TRACE
        trace.mark("queue_wait")
        try:
            deadline = request.get("_deadline")
            if deadline is not None and self.session.clock.now() >= deadline:
                resp = _reject("deadline_exceeded_in_queue",
                               "deadline expired before the request "
                               "reached a device")
            else:
                t0 = self.session.clock.now()
                # Sequential tenant attribution: this worker thread runs
                # exactly one request's device calls — bind its label so
                # invoke attributes the whole steady device time to it.
                label = self._tenant_label(request)
                # A stream member takes the segmented path: a cold first
                # frame must still deposit its low-res flow, or the stream
                # never warms (bit for bit the full program when no early
                # exit fires). That path has no half-resolution rung (a
                # held seed is keyed to the full-resolution bucket): a
                # deadline that cannot absorb one segment resolves
                # reduced_iters with deadline_missed. With the near tier
                # armed every request runs it, so its flow reaches the
                # cache.
                streaming = (request.get("_stream") is not None
                             or request.get("_flow_init") is not None
                             or request.get("_converge_tol") is not None
                             or self.cache.wants_flow)
                cache_warm = bool(request.get("_cache_warm"))
                with self.session.usage_riders([label]):
                    if streaming:
                        from raft_stereo_tpu_torch.serve.stream import stream_infer
                        out = stream_infer(
                            self.session, request["left"], request["right"],
                            flow_init=request.get("_flow_init"),
                            converge_tol=request.get("_converge_tol"),
                            deadline=deadline, prevalidated=True, trace=trace)
                        result = out.result
                        if out.warm and not cache_warm:
                            # Counted where the warm prepare ran; a
                            # near-tier seed was counted by the cache.
                            self.stream.note_warm_join(label)
                        if request.get("_stream") is not None:
                            request["_stream_flow"] = out.flow_low
                            request["_stream_shape"] = out.padded_shape
                        # Every computed response carries its low-res flow
                        # for the cache deposit (the near tier's seed).
                        request["_cache_flow"] = out.flow_low
                        request["_cache_shape"] = out.padded_shape
                        if result.quality.startswith("converged:"):
                            if cache_warm:
                                result.quality = f"warm:cache:{result.iters}"
                            else:
                                self.stream.note_converged(label)
                    else:
                        result = self.session.infer(
                            request["left"], request["right"],
                            deadline=deadline,
                            allow_half_res=request.get("allow_half_res"),
                            prevalidated=True, trace=trace)
                self._latency.observe(self.session.clock.now() - t0)
                resp = {
                    "status": "ok",
                    "quality": result.quality,
                    "disparity": result.disparity,
                    "iters": result.iters,
                    "elapsed_ms": result.elapsed_s * 1e3,
                    "deadline_missed": result.deadline_missed,
                }
        except InputRejected as e:
            resp = _reject(f"invalid_input:{e.code}", str(e))
        except DeadlineExceeded as e:
            resp = _reject(e.code, str(e))
        except SessionError as e:
            resp = _error(e.code, str(e))
        except Exception as e:  # noqa: BLE001 — the crash-proofing boundary
            resp = _error("internal", f"{type(e).__name__}: {e}")
        return resp

    def _respond(self, request: Dict) -> Dict:
        """One request, synchronously, never raising; transient failures
        re-run inline under the retry budget (the sequential twin of the
        scheduler's re-admission path)."""
        while True:
            resp = self._respond_once(request)
            if resp["status"] == "ok" or \
                    not self._note_retry_if_transient(request, resp):
                break
        return self._finalize(request, resp)

    def _finalize(self, request: Dict, resp: Dict) -> Dict:
        """Count, stamp retries, finish the trace, flight-record — the
        single resolution tail every sequential response goes through."""
        # Deposit the served frame's seed FIRST: a client that receives
        # this response and sends the next frame at once must find the
        # session warm; and one that resubmits the identical frame must
        # find the cache primed.
        self.stream.deposit(request, resp)
        self.cache.deposit(request, resp)
        if request.get("id") is not None:
            resp["id"] = request["id"]
        retries = request.get("_retries", 0)
        if retries:
            resp["retries"] = retries
        key = resp["status"]
        if resp["status"] != "ok":
            key = f'{resp["status"]}:{resp["code"]}'
        elif resp.get("quality") != "full":
            self._count("degraded")
        self._count_outcome(request, key)
        self._finish_trace(request, resp)
        self._maybe_flight(request, resp)
        return resp

    # -- bounded per-request retries (graftguard, DESIGN.md r13) -----------

    def _note_retry_if_transient(self, request: Dict, resp: Dict) -> bool:
        """Decide + account one retry: True means the caller must re-run
        (sequential) or re-admit (batched/bounce) the request instead of
        resolving this response. Deterministic failures, exhausted
        budgets, expired deadlines and a second non-finite output all
        return False — fail fast, honestly."""
        code = resp.get("code")
        if resp.get("status") == "ok" or code not in TRANSIENT_CODES:
            return False
        if code == "nonfinite_output":
            n = request.get("_nonfinite", 0) + 1
            request["_nonfinite"] = n
            if n >= 2:  # twice non-finite = deterministic, not noise
                return False
        attempt = request.get("_retries", 0)
        if attempt >= self._retry_budget:
            return False
        deadline = request.get("_deadline")
        if deadline is not None and self.session.clock.now() >= deadline:
            return False  # the original deadline is honored, not reset
        request["_retries"] = attempt + 1
        self.registry.counter(
            "raft_request_retries_total",
            "transient-failure re-admissions under the retry budget").inc()
        trace = request.get("_trace")
        if trace is not None:
            trace.event("retry", code=code, attempt=attempt + 1)
        return True

    def _requeue(self, request: Dict, wait_s: float = 1.0) -> bool:
        """Put a retried/bounced request back on the queue for the live
        scheduler generation.  The started-check and the put are ONE
        critical section under the same lock ``stop()`` flips
        ``_started`` under before its one-shot queue drain — submit()'s
        proof, reused: any item enqueued while started was True is
        provably seen by that drain, so a stop racing a retry can never
        strand the Future (a check-then-blocking-put would).  Waits up
        to ``wait_s`` on a full queue rather than bouncing off the
        backpressure bound — this request was already admitted once.
        Callers ON the live scheduler thread must pass ``wait_s=0``:
        that thread is the queue's only consumer, so waiting there can
        never succeed — it would only stall the tick loop."""
        import time as _time
        fut = request.get("_future")
        deadline = _time.monotonic() + wait_s
        while True:
            with self._lock:
                if not self._started:
                    return False
                try:
                    self._queue.put_nowait((request, fut))
                except queue.Full:
                    pass
                else:
                    self._gauge_depth.set(self._queue.qsize())
                    return True
            if _time.monotonic() >= deadline:
                return False
            # Re-admitting stranded rows during a bounce polls a full
            # queue in 10 ms beats; the bounce already owns _check_lock
            # (one recovery at a time) and serving never waits on it.
            # graftlint: disable=GC203 (bounded requeue poll inside the one-bounce-at-a-time sweep)
            _time.sleep(0.01)

    def _force_resolve(self, request: Dict, fut=None, *,
                       drain_event: bool = False) -> None:
        """Structurally resolve a request that will never be served:
        claim, reject ``service_stopped``, count, finish the trace,
        resolve the Future — the one force-resolution tail ``stop()``'s
        queue drain and ``_unadopt`` share."""
        if not self._claim(request):
            return  # resolved by a retiring generation already
        self._mark_resolved()
        resp = _reject("service_stopped",
                       "service stopped before this request ran")
        if request.get("id") is not None:
            resp["id"] = request["id"]
        trace = request.get("_trace")
        if drain_event and trace is not None:
            # Drain decision on the timeline: this request was force-
            # resolved at the hard deadline, not served.
            trace.event("drain", action="force_resolved",
                        code="service_stopped")
        self._count_outcome(request, "rejected:service_stopped")
        self._finish_trace(request, resp)
        if fut is None:
            fut = request.get("_future")
        if fut is not None:
            try:
                fut.set_result(resp)
            except Exception:  # already resolved/cancelled
                pass

    def _unadopt(self, request: Dict) -> None:
        """A retiring generation dequeued this request but must not run
        it: push it back for the live generation; if the service is no
        longer running (a stopped service's one-shot queue drain may
        already have passed — a requeue would strand it) or the queue is
        wedged, resolve it structurally — never strand it."""
        if self._requeue(request):
            return
        self._force_resolve(request)

    def _retry_scheduled(self, request: Dict, resp: Dict) -> bool:
        """Scheduler retry hook: re-admit a transiently-failed batched
        request through the shared queue (whichever generation is live
        picks it up). Called on the scheduler thread."""
        with self._lock:
            live = self._started
        if not live:
            return False
        if not self._note_retry_if_transient(request, resp):
            return False
        # wait_s=0: this hook runs on the live scheduler thread — the
        # queue's only consumer — so waiting on a full queue could never
        # succeed and would stall every batchmate's tick for the wait.
        if self._requeue(request, wait_s=0):
            return True
        # Could not re-admit (queue full) — undo nothing: the retry
        # was recorded, the response resolves with its true retry count.
        return False

    @staticmethod
    def _draining_rejection() -> Dict:
        """The one service_draining rejection — handle(), submit()'s fast
        path and its locked re-check must never drift apart on the wire."""
        return _reject("service_draining",
                       "service is draining — not accepting new requests")

    def handle(self, request: Dict) -> Dict:
        """Synchronous path: admit, run, respond. The fault-storm battery
        drives this for deterministic ordering. In batched mode with the
        scheduler running, the request rides the batch like any other
        (submit + wait); otherwise it runs the sequential session path."""
        with self._lock:
            batched_live = self._batched and self._started
            draining = self._draining
        if batched_live:
            return self.submit(request).result()
        if draining:
            rejection = self._draining_rejection()
            if request.get("id") is not None:
                rejection["id"] = request["id"]
            self._count_outcome(request, f'rejected:{rejection["code"]}')
            self._finish_trace(request, rejection)
            return rejection
        rejection = self._admit(request)
        if rejection is not None:
            if request.get("id") is not None:
                rejection["id"] = request["id"]
            self._count_outcome(request, f'rejected:{rejection["code"]}')
            self._finish_trace(request, rejection)
            return rejection
        hit = self.cache.admit(request)
        if hit is not None:
            return self._serve_cache_hit(request, hit)
        return self._respond(request)

    def submit(self, request: Dict) -> Future:
        """Async path: admission + bounded enqueue. The returned Future
        always resolves to a response dict (rejections included)."""
        fut: Future = Future()
        # Draining fast path BEFORE validation (mirrors handle()): a
        # doomed submit must not pay the O(N) finite-scan, and both
        # entry points must reject with the same code during a drain.
        # The authoritative re-check below (under the lock begin_drain
        # flips under) still closes the race window.
        with self._lock:
            draining = self._draining
        if draining:
            rejection = self._draining_rejection()
        else:
            rejection = self._admit(request)
        if rejection is None:
            with self._lock:
                live = self._started
            # An exact cache hit resolves the Future here: it never takes
            # a queue slot, never joins a batch, never counts toward
            # _outstanding. Only while the service runs: a stopped
            # service with a warm RAFT_CACHE_DIR answers not_running (the
            # started re-check under the enqueue lock stays
            # authoritative).
            hit = self.cache.admit(request) if live else None
            if hit is not None:
                fut.set_result(self._serve_cache_hit(request, hit))
                return fut
        if rejection is None:
            # started-check + enqueue under the lifecycle lock: stop()
            # flips _started under the same lock before draining, so a
            # request can never land in the queue after the drain.
            with self._lock:
                if self._draining:
                    rejection = self._draining_rejection()
                elif not self._started:
                    rejection = _reject("not_running",
                                        "service is not started")
                else:
                    try:
                        self._queue.put_nowait((request, fut))
                        self._outstanding += 1
                        self._gauge_depth.set(self._queue.qsize())
                    except queue.Full:
                        rejection = _reject(
                            "queue_full",
                            f"queue depth {self.cfg.max_queue} reached — "
                            "retry with backoff")
        if rejection is not None:
            if request.get("id") is not None:
                rejection["id"] = request["id"]
            self._count_outcome(request, f'rejected:{rejection["code"]}')
            self._finish_trace(request, rejection)
            fut.set_result(rejection)
        return fut

    # -- continuous batching ----------------------------------------------

    @staticmethod
    def _claim(request: Dict) -> bool:
        """Exactly-once resolution guard for requests that can be touched
        by two scheduler generations (a zombie waking from a hung device
        call races the bounce that re-admitted its rows). ``setdefault``
        is GIL-atomic: exactly one caller sees its own token and owns the
        counters + Future; everyone else discards. The Future itself
        already rejects double ``set_result`` — this guard keeps the
        COUNTERS honest too (the chaos-soak reconciliation invariant)."""
        token = object()
        return request.setdefault("_resolved", token) is token

    def _mark_resolved(self) -> None:
        """One admitted Future left flight — the _quiesced() side of the
        exactly-once contract. Batched callers invoke this right after a
        winning _claim; the worker loop after its Future resolves."""
        with self._lock:
            self._outstanding -= 1

    def _resolve_scheduled(self, request: Dict, resp: Dict) -> None:
        """Scheduler response sink: fold counters/latency exactly like the
        sequential ``_respond`` path, then resolve the caller's Future.
        (The scheduler already finished the request's trace.)"""
        if not self._claim(request):
            return  # another generation resolved this request first
        self._mark_resolved()
        # Deposit BEFORE the Future resolves: a woken caller posting its
        # next frame must find the session warm, and one resubmitting the
        # identical frame must find the cache primed.
        self.stream.deposit(request, resp)
        self.cache.deposit(request, resp)
        retries = request.get("_retries", 0)
        if retries and "retries" not in resp:
            resp["retries"] = retries
        key = resp["status"]
        if resp["status"] != "ok":
            key = f'{resp["status"]}:{resp["code"]}'
        else:
            self._latency.observe(resp["elapsed_ms"] / 1e3)
            if resp.get("quality") != "full":
                self._count("degraded")
        self._count_outcome(request, key)
        # Flight record BEFORE resolving the Future: a caller that wakes
        # on .result() and immediately lists RAFT_FLIGHT_DIR must see the
        # record its breach produced.
        self._maybe_flight(request, resp)
        fut = request.get("_future")
        if fut is not None:
            try:
                fut.set_result(resp)
            except Exception:  # already resolved/cancelled
                pass

    def _adopt(self, sched, item) -> bool:
        """Adopt one dequeued queue item into the scheduler generation.
        Returns False when the generation retired (defunct) while this
        thread held the just-dequeued item: a defunct scheduler must
        never adopt work (its harvest may already have run — a submit
        would strand the row), so the item is handed back for the live
        generation and the calling loop thread must exit."""
        request, fut = item
        request["_future"] = fut
        if sched.defunct:
            self._unadopt(request)
            return False
        sched.submit(request)
        return True

    def _scheduler_loop(self, sched, stop_event: threading.Event,
                        tick_s: float, hb) -> None:
        """One thread owns all batch state: drain the bounded queue into
        the scheduler, run ticks while there is work, block briefly when
        idle. On stop: the thread never touches the shared queue again
        (stop()'s own drain — or the next generation — owns it),
        un-admitted joiners are rejected (same structured
        ``service_stopped`` the sequential drain uses), and active rows
        tick to their segment-boundary exits — a row that already owns
        device state is finished, never abandoned.

        The outer try is the supervision boundary: the loop beats its
        heartbeat every iteration, and a crash (real bug or injected
        ``ChaosPlan.crash_ticks``) is recorded on the heartbeat so the
        watchdog detects a dead tick loop by state, then bounces the
        generation and re-admits the stranded rows."""
        try:
            while True:
                if sched.defunct:
                    # Generation bounced while this thread was parked (a
                    # released hang): harvest() owns every row — exiting
                    # without another tick is the only non-racy move.
                    return
                hb.beat()
                if stop_event.is_set():
                    sched.drain_pending()
                    if sched.active_rows == 0:
                        sched.shutdown()
                        return
                    sched.run_tick()
                    continue
                while True:  # drain everything currently queued
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if item is None:  # wake sentinel
                        continue
                    if not self._adopt(sched, item):
                        return
                self._gauge_depth.set(self._queue.qsize())
                if stop_event.is_set():
                    continue  # reject/finish via the stop branch above
                if not sched.run_tick():
                    try:
                        item = self._queue.get(timeout=tick_s)
                    except queue.Empty:
                        continue
                    if item is not None and not self._adopt(sched, item):
                        return
                else:
                    # Work-tick ordinal for the injected tick-loop crash
                    # (deterministic: counts only ticks that did work).
                    self.session.faults.on_tick()
        except BaseException as e:  # noqa: BLE001 — supervision boundary
            hb.mark_dead(e)
            logger.exception(
                "scheduler generation thread died — the watchdog will "
                "bounce the generation and re-admit stranded rows")

    def _worker_loop(self, stop_event: threading.Event) -> None:
        while not stop_event.is_set():
            item = self._queue.get()
            if item is None:  # stop sentinel
                break
            request, fut = item
            self._gauge_depth.set(self._queue.qsize())
            with self._lock:
                self._inflight += 1
            try:
                fut.set_result(self._respond(request))
            except Exception as e:  # noqa: BLE001 — worker must survive
                try:
                    fut.set_result(_error("internal",
                                          f"{type(e).__name__}: {e}"))
                except Exception:  # future already resolved/cancelled
                    pass
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._outstanding -= 1

    # -- generation bounce (graftguard, DESIGN.md r13) ---------------------

    def supervised_state(self) -> Optional[Dict]:
        """The supervisor's view of the current generation (None when
        the service is not running batched): heartbeat, scheduler,
        whether the generation thread is alive, and whether a stop is
        already in progress (a stopping thread exiting is not a crash)."""
        with self._lock:
            if not self._batched or not self._started:
                return None
            return {
                "heartbeat": self._heartbeat,
                "scheduler": self._scheduler,
                "thread_alive": any(t.is_alive() for t in self._workers),
                "stopping": self._stop.is_set(),
            }

    def bounce(self, reason: str = "manual") -> bool:
        """Operator action: retire the scheduler generation by hand (the
        watchdog path with a human as the detector)."""
        return self._bounce([WatchdogTrip(reason, f"manual bounce "
                                          f"({reason})")])

    def _bounce(self, trips) -> bool:
        """Watchdog response: retire the current scheduler generation,
        start a fresh one, and re-admit every harvested in-flight row
        from its original (still-held) inputs under the retry budget.
        Budget-exhausted rows fail structured (``device_hang`` for a
        hang trip, ``scheduler_restarted`` otherwise) — never silently
        dropped, never abandoned."""
        kind = trips[0].kind
        with self._lock:
            if not (self._started and self._batched
                    and self._scheduler is not None):
                return False
            old_sched = self._scheduler
            old_stop = self._stop
            old_threads = list(self._workers)
            # Defunct-then-stop, both before any harvesting: a zombie
            # thread waking mid-tick discards results (defunct) and then
            # exits through its stop branch — it can never double-resolve
            # a re-admitted row nor touch the shared queue again.
            old_sched.defunct = True
            old_stop.set()
            self._generation += 1
            gen = self._generation
            self._stop = threading.Event()
            stop_event = self._stop
            from raft_stereo_tpu_torch.serve.scheduler import BatchScheduler
            self._scheduler = BatchScheduler(
                self.session, resolve=self._resolve_scheduled,
                retry=self._retry_scheduled, generation=gen,
                stream=self.stream, cache=self.cache)
            self._heartbeat = Heartbeat("scheduler", self.session.clock)
            sched, hb = self._scheduler, self._heartbeat
            # Spawn + publish the new generation's thread INSIDE the
            # lock: supervised_state() reads scheduler/heartbeat/_stop/
            # _workers under this lock, so it can never observe the new
            # (unset) stop event paired with the old exiting thread — a
            # gap a concurrent sweep would misread as tick_crashed and
            # double-bounce the fresh, healthy generation.  The new
            # thread only briefly contends for this lock (_requeue), so
            # spawning here cannot deadlock.
            self._workers = [
                self._spawn_scheduler_thread(sched, stop_event, hb)]
        # Unpark any injected hang so the abandoned victim thread can run
        # to its (defunct, discarded) completion instead of leaking.
        self.session.faults.release_hangs()
        # Wait (bounded) for the retired thread to actually exit BEFORE
        # harvesting: a dead thread can neither steal a queue item for
        # the defunct scheduler nor race the harvest mid-tick, so the
        # harvest below is single-threaded truth.  A thread wedged in a
        # REAL device hang won't join — harvest anyway; its eventual
        # wake discards behind the scheduler's ``defunct`` checks.
        for t in old_threads:
            # Joining the dead generation's threads IS the bounce; it
            # runs under _check_lock because exactly one recovery may
            # touch generation state at a time, and the join is bounded.
            # graftlint: disable=GC203 (bounded generation join inside the serialized bounce)
            t.join(timeout=5.0)
        self._zombies.extend(t for t in old_threads if t.is_alive())
        # A bounce on the card abandons the wedged thread: a CUDA graph
        # replay cannot be cancelled (serve/supervise.py). On a live data
        # mesh a device_hang bounce probes every chip and quarantines only
        # the hung ones: the mesh shrinks to the largest divisor of its
        # base extent that fits the survivors, the epoch re-keys the mesh
        # programs, and the other chips keep serving. Stream sessions
        # pinned to a quarantined chip migrate; their held seed is on the
        # host, so they stay warm.
        quarantined: list = []
        if kind == "device_hang" and self.session.mesh_active:
            for chip in self.session.probe_chips():
                if self.session.quarantine_chip(chip):
                    quarantined.append(chip)
            if quarantined:
                migrated = self.stream.migrate_off_chips(quarantined,
                                                         self.session.mesh_chips)
                logger.warning(
                    "quarantined chip(s) %s after device_hang: mesh now %d-wide, "
                    "%d stream session(s) migrated", quarantined,
                    self.session.mesh_chips, migrated)
        self.registry.counter(
            "raft_sched_restarts_total",
            "scheduler generation bounces by watchdog reason",
            reason=kind).inc()
        logger.warning("scheduler generation bounced (%s) -> g%d",
                       kind, gen)
        harvested = old_sched.harvest()
        fail_code = ("device_hang" if kind == "device_hang"
                     else "scheduler_restarted")
        requeued = failed = 0
        for request in harvested:
            if request.get("_resolved") is not None:
                # The retiring generation resolved this request before it
                # went defunct (its exits landed mid-bounce): the caller
                # already has a legitimate response — nothing to re-admit.
                continue
            trace = request.get("_trace")
            if trace is not None:
                trace.event("generation_bounce", reason=kind,
                            generation=gen)
            resp = _error(fail_code,
                          f"request interrupted by a scheduler generation "
                          f"bounce ({kind}): {trips[0].reason}")
            if self._note_retry_if_transient(request, resp) and \
                    self._requeue(request):
                requeued += 1
                continue
            failed += 1
            if request.get("id") is not None:
                resp["id"] = request["id"]
            if trace is not None:
                trace.finish(status="error", code=fail_code)
            self._resolve_scheduled(request, resp)
        # Every watchdog action leaves a flight record naming its reason
        # (the chaos-soak invariant); the recorder is failure-isolated
        # and a no-op when unarmed.
        self.session.flight.record({
            "schema": 1,
            "reasons": [f"watchdog:{t.kind}" for t in trips],
            "watchdog": [{"kind": t.kind, "reason": t.reason,
                          "detail": t.detail} for t in trips],
            "generation": {"from": gen - 1, "to": gen},
            "requests": {"harvested": len(harvested),
                         "requeued": requeued, "failed": failed},
            "mesh": ({"quarantined": quarantined,
                      "n_data": self.session.mesh_chips}
                     if quarantined else None),
            "breaker": self.session.breaker.status(),
            "metrics": self.registry.snapshot(),
        }, trace_id=f"bounce-g{gen}")
        return True

    # -- recovery plane (graftheal, DESIGN.md r22) -------------------------

    def heal_sweep(self) -> Dict:
        """One recovery-plane sweep: at most one half-open breaker-rung
        canary (strict reverse trip order), then one probe pass over the
        quarantined chips whose probation is due, then the stream sessions
        parked off the mesh re-pinned onto a re-grown one. Not wired into
        the Supervisor's monitor thread: detection and recovery run on
        different triggers; the CLI's wait loop drives it, tests call it on
        the FakeClock. With ``RAFT_HEAL=0`` it does nothing."""
        rung = self.session.heal_breaker()
        mesh = self.session.heal_mesh()
        repinned = 0
        if mesh["readmitted"]:
            # Their held seeds are on the host: they come back warm.
            repinned = self.stream.repin_unplaced(self.session.mesh_chips)
        return {"breaker": rung, "mesh": mesh, "stream_repinned": repinned}

    def supervision_status(self) -> Dict:
        """The /healthz ``supervision`` block: generation, drain state,
        heartbeat ages, watchdog/retry config, restart + trip counters."""
        now = self.session.clock.now()
        with self._lock:
            gen = self._generation
            draining = self._draining
            hb = self._heartbeat
            sched = self._scheduler
            alive = any(t.is_alive() for t in self._workers)
        uploader = sched.uploader if sched is not None else None
        return {
            "generation": gen,
            "draining": draining,
            "retry_budget": self._retry_budget,
            "drain_grace_ms": self._drain_grace_s * 1e3,
            "watchdog": (self._supervisor.status()
                         if self._supervisor is not None else
                         {"armed": False,
                          "floor_ms": self._watchdog_s * 1e3}),
            "heartbeats": {
                "scheduler_age_s": hb.age(now) if hb is not None else None,
                "scheduler_alive": alive,
                "scheduler_died": (str(hb.died)
                                   if hb is not None and hb.died is not None
                                   else None),
                "uploader_alive": (uploader.alive
                                   if uploader is not None else None),
                "uploader_dead": (str(uploader.dead)
                                  if uploader is not None
                                  and uploader.dead is not None else None),
            },
            "in_flight_invocations": self.session.watch.count,
            "restarts": {labels["reason"]: int(v) for labels, v in
                         self.registry.series("raft_sched_restarts_total")},
            "watchdog_trips": {labels["kind"]: int(v) for labels, v in
                               self.registry.series(
                                   "raft_watchdog_trips_total")},
            "retries": int(self.registry.value(
                "raft_request_retries_total")),
        }

    # -- health -----------------------------------------------------------

    def status(self) -> Dict:
        """The /healthz document — every number here is a registry read
        (the same counters /metrics exposes), no service-private state."""
        counts = {labels["outcome"]: int(v) for labels, v in
                  self.registry.series("raft_requests_total")}

        def pct(p: float) -> Optional[float]:
            v = self._latency.percentile(p)
            return None if v is None else v * 1e3

        return {
            # graftfleet: generation identity + age, top-level — the
            # fleet router keys rolling deploys on fingerprint_id and
            # detects silent restarts from uptime_s going backwards.
            "fingerprint_id": self.session.fingerprint_id(),
            "uptime_s": self.session.clock.now() - self._born,
            "queue": {"depth": self._queue.qsize(),
                      "max": self.cfg.max_queue,
                      "workers": (1 if self._batched
                                  else self.cfg.workers)},
            "requests": counts,
            "latency_ms": {"p50": pct(0.50), "p99": pct(0.99),
                           "n": self._latency.n},
            "batching": (self._scheduler.status()
                         if self._scheduler is not None else None),
            # The bounded stream-session table and its warm and converged
            # counters (serve/stream.py).
            "stream": self.stream.status(),
            # The response cache: hit, miss and near counters, bytes, the
            # tier config (serve/cache.py).
            "cache": self.cache.status(),
            "supervision": self.supervision_status(),
            # graftheal: the recovery plane — per-rung/per-chip
            # probation state, flap caps, MTTR (serve/heal.py knobs;
            # session.heal_status()).
            "heal": self.session.heal_status(),
            # The operator-plane capacity block (obs/capacity.py):
            # per-bucket theoretical requests/s from the warmed EMAs,
            # live saturation from the tick deck, headroom gauges
            # published as a side effect.
            "capacity": self.session.capacity_status(),
            "session": self.session.status(),
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of the shared registry — the
        /metrics endpoint body (session + service + scheduler series,
        one scrape)."""
        return self.registry.render_prometheus()
