"""Iteration-level continuous batching over the segmented refinement.

The port's counterpart of the JAX package's ``serve/scheduler.py``, with
the same request flow, responses, counters and spans. LLM servers batch at
decode-token granularity: requests join and leave a running device batch
between token steps. RAFT-Stereo's refinement has the same shape (the
session's ``advance`` program takes a carry ``{net, inp, fmap1, fmap2,
coords1}`` k iterations on), so this module batches at segment
granularity:

- each **tick** runs ONE batched ``advance`` program over every active
  request of one (padded shape, config) bucket, padded up to a **batch
  bucket** (pad rows replicate live rows and are never read back); on the
  card it is a CUDA graph captured at that batch, and the loop kernels take
  the whole batch in one launch each;
- **joins** happen at tick boundaries: a waiting request's pair is copied
  to the card by a background thread (the uploader) while the current
  segment runs, then a batched ``prepare`` builds the joiners' carries
  (row by row, ``serve/session.py``), which are concatenated onto the
  running batch;
- **exits** happen at segment boundaries: rows that finished their
  iterations, or whose deadline provably cannot absorb another batched
  segment (the EMA cost is keyed per program and batch bucket), leave the
  batch and pay the mask-head ``epilogue`` once, as one stacked call;
- a row's output does not depend on its batchmates within one batch width:
  every op of the segment is row-independent, and pad rows are copies of
  live rows.

**Carries stay on the card between ticks.** Joins, exits and pads are
``torch.cat`` and ``index_select`` on device tensors
(``stack_refinement_states``, ``take_refinement_rows``), never a trip
through the host. On a data mesh (``serve/session.py``) the carry is a
``ShardedCarry``: the same two helpers gather and join each part on its
own device, and the next mesh program places rows on their shards, device
to device; joiners are sorted by their stream's chip so a stream's rows
keep their shard. On the card every such op, and the uploader's copies, run
under the session's ``device_ops`` (the ``_CaptureGate`` of each device
shared): a CUDA graph capture fails on an allocation or a copy made on its
device while it runs. The uploader's copies run on a side stream and record an
event, which the tick's stream waits on before the pair is read.

**Warm joins and the convergence exit** (``serve/stream.py``,
``serve/cache.py``): a row may carry a 1/8-res x-only seed (a stream's
previous frame, or a near-tier cache neighbor). The uploader copies it
beside the pair; cold and warm joiners then go to two batched programs,
``prepare`` and ``prepare_warm`` (a cold row never reads a seed buffer),
whose carries share the one ``advance`` from there on. After each
``advance`` a row whose ``dnorm`` (fetched with the tick's results, no
second synchronization) fell below its tolerance exits with
``converged:k`` (``warm:cache:k`` for a near-tier seed). An exiting row's
1/8-res flow rides its request back to the service for the stream deposit
and the cache.

The scheduler is single-threaded by design: all batch state is owned by
the one thread calling :meth:`run_tick` (the service's scheduler thread,
or a test driving ticks). Only the aggregate metrics are shared, through
the session's registry, with /healthz readers.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.models.raft_stereo import (carry_rows, stack_refinement_states,
                                                      take_refinement_rows)
from raft_stereo_tpu_torch.obs.ledger import ledger_id
from raft_stereo_tpu_torch.obs.tracing import NULL_TRACE, stage
from raft_stereo_tpu_torch.obs.usage import sanitize_tenant
from raft_stereo_tpu_torch.serve.degrade import SAFETY
from raft_stereo_tpu_torch.serve.session import (InferenceFailed, InferenceSession,
                                                 SessionError)

logger = logging.getLogger(__name__)


def _reject(code: str, message: str) -> Dict:
    return {"status": "rejected", "code": code, "message": message}


def _error(code: str, message: str) -> Dict:
    return {"status": "error", "code": code, "message": message}


class _Row:
    """Bookkeeping for one admitted request while it rides the batch."""

    __slots__ = ("request", "padder", "orig_h", "orig_w", "deadline",
                 "iters_done", "t_start", "dev_pair", "dev_event", "upload_error",
                 "uploaded", "tenant_label", "flow_init", "dev_flow",
                 "converge_tol", "converged", "cache_warm")

    def __init__(self, request, padder, deadline, t_start,
                 tenant_label: str = "default"):
        self.request = request
        self.padder = padder
        self.orig_h = request["left"].shape[1]
        self.orig_w = request["left"].shape[2]
        self.deadline = deadline
        self.iters_done = 0
        self.t_start = t_start
        self.dev_pair = None
        self.dev_event = None  # the upload's CUDA event (None on the CPU)
        self.upload_error: Optional[Exception] = None
        self.uploaded = threading.Event()
        # Bounded usage label (obs/usage.py first-come discipline),
        # resolved once at admission: every device call this row rides
        # attributes its exact share of device seconds here.
        self.tenant_label = tenant_label
        # A warm frame carries its previous frame's padded low-res flow
        # (stamped at admission; it stays ON the request dict, so a
        # generation bounce re-admits the row still warm); the tolerance
        # arms the convergence exit.
        self.flow_init = request.get("_flow_init")
        self.dev_flow = None
        self.converge_tol = request.get("_converge_tol")
        self.converged = False
        # A near-tier seed rides the same warm machinery as a stream frame
        # but is labeled ``warm:cache:k`` and counts in no stream metric.
        self.cache_warm = bool(request.get("_cache_warm"))

    @property
    def trace(self):
        """The request's span timeline (NULL when the request came in
        without one — tests driving the scheduler directly)."""
        return self.request.get("_trace") or NULL_TRACE


class _Bucket:
    """Active batch + FIFO of waiting joiners for one padded shape."""

    def __init__(self, key: Tuple[int, int]):
        self.key = key                      # (padded_h, padded_w)
        self.rows: List[_Row] = []          # row i of carry == rows[i]
        # Batched state dict; its leading dim may EXCEED len(rows) — live
        # rows are the prefix, the rest are dead pad rows. Keeping the
        # carry at batch-bucket width between ticks means a steady
        # occupancy that is not itself a bucket size (say 5 under
        # buckets 4/8) pays the pad/trim gathers only when the batch
        # composition changes, not on every segment.
        self.carry = None
        self.pending: "collections.deque[_Row]" = collections.deque()
        # The join group currently mid-prepare: rows popped from
        # ``pending`` but not yet merged into ``rows``. Without this,
        # a hung or terminally-failing batched prepare strands its
        # joiners in a local variable no harvest or bucket-failure path
        # can see — their Futures would never resolve.
        self.joining: List[_Row] = []

    @property
    def carry_width(self) -> int:
        return 0 if self.carry is None else carry_rows(self.carry)

    @property
    def has_work(self) -> bool:
        return bool(self.rows or self.pending)


def _upload(session: InferenceSession, stream, arrays) -> tuple:
    """Host arrays as tensors on the session's device: ``(tensors,
    event)``. On the card the copies run on ``stream`` under the session's
    ``device_ops`` and record an event the tick waits on; on the CPU the
    tensors share the arrays' memory and there is no event."""
    if session.device.type != "cuda":
        return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), None
    with session.device_ops(), torch.cuda.stream(stream):
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            session.device, non_blocking=True) for a in arrays)
        event = torch.cuda.Event()
        event.record(stream)
    return tensors, event


def _await_upload(row: "_Row") -> None:
    """Order the tick's stream after the row's upload (the pair and any
    seed), and keep the allocator from reusing their memory before the
    tick's work on them has run. Called under ``device_ops``."""
    if row.dev_event is None:
        return
    current = torch.cuda.current_stream(row.dev_pair[0].device)
    current.wait_event(row.dev_event)
    for t in row.dev_pair + ((row.dev_flow,) if row.dev_flow is not None else ()):
        t.record_stream(current)
    row.dev_event = None


class _Uploader:
    """Background host->device transfer: pads and uploads a joiner's image
    pair while the current segment executes on device, so a join costs the
    batch a carry concat, not a host round trip. On the card the copies run
    on the uploader's own stream (:func:`_upload`). The pad and the upload
    land in the row's trace as CONCURRENT spans (``pad``, ``upload``) —
    visible in the timeline, excluded from the tiled latency partition
    (they overlap a running segment by design) — and as the profiler
    ranges ``raft.pad`` and ``raft.upload``.

    Crash-proofing (graftguard, DESIGN.md r13): a per-row transfer
    failure was always surfaced on that row, but a crash in the loop
    itself (trace plumbing, the injected ``ChaosPlan.crash_uploads``
    fault, any future bug outside the per-row try) used to kill the
    thread silently and leave every joiner's ``uploaded`` event — and
    therefore its Future — stranded forever.  Now a thread-killing crash
    records itself in ``dead``, resolves the current row AND everything
    still queued with that error (the scheduler turns it into a
    structured ``upload_failed``), and later ``push`` calls short-
    circuit the same way.  The watchdog bounces the generation onto a
    fresh uploader; this class only guarantees nothing is ever stranded.
    ``dead``/``busy_since`` are plain attributes written by one thread
    and read by the supervisor — monotonic one-way flags, no lock
    needed."""

    def __init__(self, session: InferenceSession):
        self._session = session
        self._clock = session.clock
        self._faults = session.faults
        self._stream = None  # the copies' CUDA stream, made by the thread
        self.dead: Optional[BaseException] = None
        self.busy_since: Optional[float] = None
        self._q: "queue.Queue[Optional[_Row]]" = queue.Queue()
        # stop() is the queue's None sentinel — the loop exits after
        # draining, and the generation watchdog owns replacement;
        # joining would park stop() behind a possibly-wedged device
        # upload, the exact hang the watchdog exists to break.
        # graftlint: disable=GC206 (sentinel stop; watchdog owns a wedged uploader)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="stereo-uploader")
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def _fail_row(self, row: _Row, exc: BaseException) -> None:
        row.upload_error = exc
        row.uploaded.set()

    def push(self, row: _Row) -> None:
        if self.dead is not None:
            self._fail_row(row, self.dead)
            return
        self._q.put(row)
        # Death raced the put: the dying loop's queue drain may already
        # have finished, so re-check — an unresolved ``uploaded`` event
        # strands the joiner's Future forever.
        if self.dead is not None and not row.uploaded.is_set():
            self._fail_row(row, self.dead)

    def stop(self) -> None:
        self._q.put(None)

    def _loop(self) -> None:
        while True:
            row = self._q.get()
            if row is None:
                return
            try:
                self.busy_since = self._clock.now()
                if self._faults is not None:
                    self._faults.on_upload()
                t0 = t_up = self._clock.now()
                try:
                    with stage("pad", row.trace):
                        lp, rp = row.padder.pad_np(row.request["left"],
                                                   row.request["right"])
                    t_up = self._clock.now()
                    row.trace.add_span("pad", t0, t_up, concurrent=True)
                    session = self._session
                    if self._stream is None and session.device.type == "cuda":
                        with session.device_ops():
                            self._stream = torch.cuda.Stream(session.device)
                    arrays = (lp, rp)
                    if row.flow_init is not None:
                        # The warm seed, already at the padded low-res
                        # bucket shape (only a matching field is handed
                        # out), copied beside the pair.
                        arrays += (np.asarray(row.flow_init, np.float32),)
                    with stage("upload", row.trace):
                        tensors, row.dev_event = _upload(session, self._stream, arrays)
                    row.dev_pair = tensors[:2]
                    row.dev_flow = tensors[2] if len(tensors) > 2 else None
                except Exception as e:  # noqa: BLE001 — surfaced per-row
                    row.upload_error = e
                row.trace.add_span("upload", t_up, self._clock.now(),
                                   concurrent=True)
                row.uploaded.set()
                self.busy_since = None
            except BaseException as e:  # noqa: BLE001 — thread-killing crash
                logger.exception(
                    "uploader thread died — current and queued joiners "
                    "fail upload_failed; the watchdog bounces the "
                    "generation onto a fresh uploader")
                self.dead = e
                self._fail_row(row, e)
                while True:
                    try:
                        later = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if later is not None:
                        self._fail_row(later, e)
                return


class BatchScheduler:
    """Continuous-batching engine over one :class:`InferenceSession`.

    ``resolve(row_request, response)`` is called exactly once per admitted
    request (the service wires its Future resolution + counters in; tests
    collect responses). All scheduling state is confined to the thread
    calling :meth:`submit` / :meth:`run_tick`.
    """

    def __init__(self, session: InferenceSession, *,
                 resolve: Optional[Callable[[Dict, Dict], None]] = None,
                 retry: Optional[Callable[[Dict, Dict], bool]] = None,
                 generation: int = 0, stream=None, cache=None):
        if session.cfg.max_batch < 2:
            raise ValueError("BatchScheduler needs SessionConfig.max_batch "
                             ">= 2; use the sequential worker path at 1")
        self.session = session
        # Stamped on every tick flight-deck record (obs/deck.py) so a
        # post-mortem can see which scheduler generation ran a tick —
        # the service passes its generation counter; tests driving the
        # scheduler directly default to 0.
        self.generation = generation
        self.resolve = resolve or self._default_resolve
        # Supervision hooks (serve/supervise.py): ``retry`` is consulted
        # before a failed response is finalized — True means the service
        # re-admitted the request under its retry budget and this
        # scheduler must neither finish the trace nor resolve the
        # Future.  ``defunct`` is flipped (once, by the service, before
        # harvest) when a generation bounce retires this scheduler: a
        # zombie thread waking from a hung device call then discards its
        # results instead of double-resolving rows the new generation
        # re-admitted.
        self.retry = retry
        self.defunct = False
        # The stream module's accounting hooks (serve/stream.py
        # StreamManager): warm joins and convergence exits are counted
        # where they happen, in this tick loop; tests driving the
        # scheduler directly may leave it None.
        self.stream = stream
        # The response cache (serve/cache.py): exact hits never reach the
        # scheduler; the couplings here are the cumulative hit column on
        # each deck tick row and the deposit's low-res flow.
        self.cache = cache
        self.uploader = _Uploader(session)
        self._buckets: Dict[Tuple[int, int], _Bucket] = {}
        self._rr: List[Tuple[int, int]] = []   # round-robin bucket order
        self._rr_next = 0
        # Guards the bucket map: /healthz readers iterate it from other
        # threads while submit() (scheduler thread) inserts new shape
        # buckets. Per-bucket rows/carries need no lock — they are touched
        # only by the scheduling thread. Aggregate metrics live in the
        # session's registry (self-locking instruments), so a restart's
        # fresh scheduler keeps accumulating into the same series.
        self._lock = threading.Lock()
        reg = session.registry
        self.registry = reg
        self._m_ticks = reg.counter("raft_sched_ticks_total",
                                    "scheduler ticks run")
        self._m_joins = reg.counter("raft_sched_joins_total",
                                    "requests joined into a device batch")
        self._m_exits = reg.counter("raft_sched_exits_total",
                                    "rows exited at a segment boundary")
        self._m_pad_rows = reg.counter(
            "raft_sched_pad_rows_total",
            "dead pad rows advanced (batch-bucket padding waste)")
        self._m_batch_rows = reg.counter(
            "raft_sched_batch_rows_total",
            "total rows advanced (live + pad)")
        self._tick_hist = reg.histogram(
            "raft_sched_tick_seconds",
            "wall time of one scheduler tick (bounded reservoir)",
            reservoir=512)

    # -- request intake ---------------------------------------------------

    @staticmethod
    def _default_resolve(request: Dict, resp: Dict) -> None:
        fut = request.get("_future")
        if fut is not None:
            try:
                fut.set_result(resp)
            except Exception:  # already resolved/cancelled
                pass

    def submit(self, request: Dict) -> None:
        """Admit one validated request (arrays already canonical, deadline
        already stamped as ``_deadline``) into its shape bucket's join
        queue and start its host->device upload immediately."""
        padder = self.session.padder_for(request["left"].shape)
        row = _Row(request, padder, request.get("_deadline"),
                   self.session.clock.now(),
                   tenant_label=self.session.usage.label(
                       sanitize_tenant(request.get("tenant"))))
        key = padder.padded_shape
        bucket = self._buckets.get(key)
        if bucket is None:
            with self._lock:
                bucket = self._buckets[key] = _Bucket(key)
            self._rr.append(key)
        bucket.pending.append(row)
        self.uploader.push(row)

    def _bucket_list(self) -> List[_Bucket]:
        with self._lock:
            return list(self._buckets.values())

    @property
    def has_work(self) -> bool:
        return any(b.has_work for b in self._bucket_list())

    @property
    def active_rows(self) -> int:
        return sum(len(b.rows) for b in self._bucket_list())

    # -- the tick ---------------------------------------------------------

    def run_tick(self) -> bool:
        """Run one scheduler tick on the next bucket with work (round
        robin). Returns False when every bucket is idle. Never raises: a
        terminal failure fails the affected bucket's requests with
        structured error responses and clears that bucket."""
        bucket = self._next_bucket()
        if bucket is None:
            return False
        # Tick flight-deck record (obs/deck.py): opened on THIS thread
        # before any device work, closed in the finally so a failed or
        # zombie-discarded tick still leaves its row. Queue depth is the
        # scheduler's own view — joiners waiting across all buckets at
        # tick start.
        deck = self.session.deck
        tick = deck.begin_tick(
            bucket=f"{bucket.key[0]}x{bucket.key[1]}",
            generation=self.generation,
            queue_depth=sum(len(b.pending) for b in self._bucket_list()))
        if self.cache is not None:
            # Cumulative hit count at tick start: two deck rows' difference
            # is the hit rate over that window (obs/deck.py report).
            tick.cache_hits = self.cache.hits_cumulative
        t0 = time.perf_counter()
        try:
            with stage("tick", tick=tick.seq):
                self._tick_bucket(bucket, tick)
        except Exception as e:  # noqa: BLE001 — the crash-proof boundary
            logger.exception("tick failed for bucket %s", bucket.key)
            self._fail_bucket(bucket, e)
        finally:
            deck.end_tick(tick)
        self._m_ticks.inc()
        self._tick_hist.observe(time.perf_counter() - t0)
        return True

    def _next_bucket(self) -> Optional[_Bucket]:
        for _ in range(len(self._rr)):
            key = self._rr[self._rr_next % len(self._rr)]
            self._rr_next += 1
            b = self._buckets[key]
            # A bucket whose only work is still uploading counts as work
            # (has_work) but cannot tick yet — skip it this round.
            if b.rows or (b.pending and b.pending[0].uploaded.is_set()):
                return b
        return None

    def _tick_bucket(self, bucket: _Bucket, tick) -> None:
        session = self.session
        clock = session.clock
        m_iters = session.cfg.valid_iters // session.cfg.segments
        ph, pw = bucket.key

        # 1. Joins: admit uploaded joiners (FIFO) up to capacity; one
        # batched prepare builds their carries. The group is published
        # on ``bucket.joining`` (the same list object — appends are
        # visible) for the whole window between leaving ``pending`` and
        # merging into ``rows``: a hang/crash inside the batched prepare
        # must leave these rows harvestable, never stranded.
        joiners: List[_Row] = []
        bucket.joining = joiners
        capacity = session.cfg.max_batch - len(bucket.rows)
        while capacity > 0 and bucket.pending and \
                bucket.pending[0].uploaded.is_set():
            row = bucket.pending.popleft()
            # Published on ``joining`` BEFORE any respond/admit decision:
            # a generation bounce landing while this row is only in a
            # local (its ``_respond`` below discards behind ``defunct``)
            # must still find it harvestable, never stranded.
            joiners.append(row)
            if row.upload_error is not None:
                self.session.count_request(ok=False)
                # Structured + transient: the retry budget re-admits it
                # (a bounced generation brings a fresh uploader).
                self._respond(row, _error(
                    "upload_failed",
                    f"host->device upload failed: {row.upload_error}"))
                if self.defunct:
                    return  # harvest() owns the joining rows now
                joiners.pop()  # resolved or re-admitted: leave the group
                continue
            now = clock.now()
            if row.deadline is not None and now >= row.deadline:
                self._respond(row, _reject(
                    "deadline_exceeded_in_queue",
                    "deadline expired before the request joined a batch"))
                if self.defunct:
                    return  # harvest() owns the joining rows now
                joiners.pop()  # resolved: leave the join group
                continue
            # Queue wait ends here: admission-to-join is the span.
            row.trace.mark("queue_wait")
            capacity -= 1
        if joiners:
            # Warm joiners (a held seed rode in with the request) go
            # through prepare_warm, cold ones through prepare: two calls at
            # most, and a cold row never reads a seed buffer. The carries
            # then share ONE advance (the x-only seed keeps flow y == 0).
            cold = [r for r in joiners if r.flow_init is None]
            warm = [r for r in joiners if r.flow_init is not None]
            # Chip affinity on a data mesh: within each group a stable sort
            # by the stream session's chip (stamped ``_chip`` at admission),
            # so a stream's rows keep landing on the same shard (a mesh
            # program splits the batch into contiguous shards). Rows
            # without a chip sort first; FIFO holds within a chip, and off
            # the mesh (no row has a chip) nothing moves.
            def _chip_key(r: _Row) -> int:
                c = r.request.get("_chip")
                return c if isinstance(c, int) else -1
            cold.sort(key=_chip_key)
            warm.sort(key=_chip_key)
            # The published join group follows the carry order below (same
            # membership, so a harvest still finds every row).
            joiners[:] = cold + warm
            states = []
            for kind, group in (("prepare", cold), ("prepare_warm", warm)):
                if not group:
                    continue
                bb = session.batch_bucket(len(group))
                pad = bb - len(group)
                with session.device_ops():
                    for r in group:
                        _await_upload(r)
                    lefts = [r.dev_pair[0] for r in group]
                    rights = [r.dev_pair[1] for r in group]
                    args = (torch.cat(lefts + [lefts[0]] * pad, dim=0),
                            torch.cat(rights + [rights[0]] * pad, dim=0))
                    if kind == "prepare_warm":
                        # The seeds stacked, pad rows replicating row 0.
                        flows = [r.dev_flow for r in group]
                        args += (torch.cat(flows + [flows[0]] * pad, dim=0),)
                p0 = clock.now()
                # Rider binding (obs/usage.py): the group's tenant labels
                # ride this device call, and invoke splits its device
                # seconds across them.
                split = {}
                with session.usage_riders([r.tenant_label for r in group]):
                    (state_g,) = self._device_call(
                        kind, ph, pw, 0, bb, *args, traces=[r.trace for r in group],
                        stages=split)
                if self.defunct:
                    return  # retired mid-prepare: harvest() took the
                    #         joining rows; this result is discarded.
                p1 = clock.now()
                # The program id joins this span to its ledger row; the
                # tick seq links it to the flight-deck record.
                prep_id = session.ledger_key_id(kind, ph, pw, 0, b=bb)
                for r in group:  # one device interval, fanned per rider
                    r.trace.add_span(kind, p0, p1, batch=len(group),
                                     program=prep_id, tick=tick.seq, **split)
                if pad:
                    with session.device_ops():
                        state_g = take_refinement_rows(state_g, range(len(group)))
                states.append(state_g)
            if self.stream is not None:
                for r in warm:
                    # A near-tier seed is no stream frame: its hit was
                    # counted by ResponseCache.admit.
                    if not r.cache_warm:
                        self.stream.note_warm_join(r.tenant_label)
            with session.device_ops():
                state_j = stack_refinement_states(states)
                if bucket.carry is None:
                    bucket.carry = state_j
                else:
                    live = (bucket.carry
                            if bucket.carry_width == len(bucket.rows) else
                            take_refinement_rows(bucket.carry,
                                                 range(len(bucket.rows))))
                    bucket.carry = stack_refinement_states([live, state_j])
                for r in joiners:
                    # The carry holds what the row needs.
                    r.dev_pair = r.dev_flow = None
            bucket.rows.extend(joiners)
            self._m_joins.inc(len(joiners))
            tick.joins = len(joiners)
            tick.warm_joins = len(warm)
        bucket.joining = []

        # Local binding for the rest of the tick: a concurrent generation
        # bounce REBINDS bucket.rows/carry (harvest), so re-reading the
        # attribute mid-tick would index a list someone else emptied. The
        # snapshot keeps this tick's view consistent; every result lands
        # behind a ``defunct`` check, so a retired tick discards instead
        # of racing the re-admitted rows.
        rows = bucket.rows
        n = len(rows)
        if n == 0:
            return

        # 2. One batched segment over the whole active set, padded up to
        # its batch bucket (pad rows replicate row 0 — dead carries). The
        # output stays at bucket width: a steady composition re-enters
        # here next tick with carry_width == bb and pays no gather.
        bb = session.batch_bucket(n)
        if bucket.carry_width != bb:
            with session.device_ops():
                bucket.carry = take_refinement_rows(
                    bucket.carry, list(range(n)) + [0] * (bb - n))
        adv_key = session.cache_key("advance", ph, pw, m_iters, b=bb)
        a0 = clock.now()
        split = {}
        with session.usage_riders([r.tenant_label for r in rows]):
            state, _rowsum, dnorm = self._device_call(
                "advance", ph, pw, m_iters, bb, bucket.carry,
                traces=[r.trace for r in rows], stages=split)
        if self.defunct:
            return  # retired mid-advance: harvest() owns these rows
        a1 = clock.now()
        bucket.carry = state
        adv_id = ledger_id(adv_key)
        tick.occupancy = n
        tick.batch = bb
        tick.pad_rows = bb - n
        tick.iters = m_iters
        tick.program = adv_id
        for row in rows:
            row.iters_done += m_iters
            row.trace.add_span("advance", a0, a1, iters=m_iters,
                               occupancy=n, batch=bb, program=adv_id,
                               tick=tick.seq, **split)
        self.registry.counter(
            "raft_sched_occupancy_total",
            "ticks by live-row occupancy", rows=str(n)).inc()
        self.registry.counter(
            "raft_sched_bucket_ticks_total",
            "ticks by the batch bucket their advance ran at", b=str(bb)).inc()
        self._m_batch_rows.inc(bb)
        self._m_pad_rows.inc(bb - n)

        # 3. Exits: finished rows, rows whose convergence norm fell below
        # their tolerance (the per-row dnorm came back with the advance's
        # outputs, so the check costs no synchronization), plus rows whose
        # deadline cannot absorb another batched segment (per-row anytime
        # degradation — the first segment always runs because this check
        # only happens after one).
        now = clock.now()
        est = session.estimate(adv_key)
        exits: List[int] = []
        n_converged = 0
        for i, row in enumerate(rows):
            if row.iters_done >= session.cfg.valid_iters:
                exits.append(i)
            elif row.converge_tol is not None and float(dnorm[i]) < row.converge_tol:
                # Honest label: converged:k, or warm:cache:k for a
                # near-tier seed, k the iterations this row ran.
                row.converged = True
                row.trace.event(
                    "converged",
                    label=(f"warm:cache:{row.iters_done}" if row.cache_warm
                           else f"converged:{row.iters_done}"),
                    norm=float(dnorm[i]), tol=row.converge_tol)
                exits.append(i)
                n_converged += 1
                if self.stream is not None and not row.cache_warm:
                    self.stream.note_converged(row.tenant_label)
            elif row.deadline is not None and (
                    now >= row.deadline
                    or (est is not None
                        and now + est * SAFETY > row.deadline)):
                row.trace.event(
                    "degrade", label=f"reduced_iters:{row.iters_done}",
                    reason=("deadline_expired" if now >= row.deadline
                            else "predicted_overshoot"))
                exits.append(i)
        if not exits:
            return
        eb = session.batch_bucket(len(exits))
        with session.device_ops():
            ex_state = take_refinement_rows(
                bucket.carry, exits + [exits[0]] * (eb - len(exits)))
        e0 = clock.now()
        split = {}
        with session.usage_riders([rows[i].tenant_label for i in exits]):
            flow_up, flow_low = self._device_call(
                "epilogue", ph, pw, 0, eb, ex_state,
                traces=[rows[i].trace for i in exits], stages=split)
        if self.defunct:
            return  # retired mid-epilogue: harvest() owns these rows
        e1 = clock.now()
        epi_id = session.ledger_key_id("epilogue", ph, pw, 0, b=eb)
        for i in exits:
            rows[i].trace.add_span("epilogue", e0, e1,
                                   batch=len(exits),
                                   program=epi_id, tick=tick.seq, **split)
        now = clock.now()
        for j, i in enumerate(exits):
            request = rows[i].request
            if request.get("_stream") is not None:
                # The exiting row's 1/8-res flow seeds the stream's next
                # frame: it rides the request so the service deposits it
                # BEFORE the caller's Future resolves.
                request["_stream_flow"] = np.array(flow_low[j:j + 1], dtype=np.float32)
                request["_stream_shape"] = bucket.key
            if self.cache is not None and self.cache.wants_flow:
                # With the near tier armed every exit carries its flow for
                # the cache's deposit; a disabled tier copies nothing.
                request["_cache_flow"] = np.array(flow_low[j:j + 1], dtype=np.float32)
                request["_cache_shape"] = bucket.key
            self._finish(rows[i], flow_up[j:j + 1], now)
        self._m_exits.inc(len(exits))
        tick.exits = len(exits)
        tick.converged = n_converged
        if self.defunct:
            return  # never write stale rows back over a harvested bucket
        survivors = [i for i in range(n) if i not in set(exits)]
        bucket.rows = [rows[i] for i in survivors]
        if survivors:
            with session.device_ops():
                bucket.carry = take_refinement_rows(bucket.carry, survivors)
        else:
            bucket.carry = None

    # -- device calls with breaker retry ----------------------------------

    def _device_call(self, kind: str, ph: int, pw: int, iters: int,
                     b: int, *args, traces=(), stages=None):
        """get_program + invoke, walking the breaker ladder on classified
        kernel failures exactly like the sequential path (the carry is
        plain data — it composes with a rebuilt rung's programs).
        ``traces``: timelines of every request riding this call — a trip
        becomes a decision event on each (the span itself is fanned out by
        the caller, which knows the per-phase interval, with the call's
        copy-in, replay and copy-out split that ``stages`` receives). The
        session's one recovery step decides: a sticky CUDA error or a
        failed capture ends the call in a structured error, and on the card
        a failure whose rung would leave the hand-written kernels is
        ``kernel_failed``; :meth:`run_tick` then fails every row of the
        bucket with that code."""
        session = self.session
        last: Optional[Exception] = None
        for _ in range(len(session.breaker.ladder) + 1):
            try:
                prog = session.get_program(kind, ph, pw, iters, b=b)
                return session.invoke(prog, *args, stages=stages)
            except Exception as e:  # noqa: BLE001 — _handle_failure filters
                last = e
                session._handle_failure(e, traces=traces)
        raise InferenceFailed(
            "ladder_exhausted", f"breaker retries exhausted: {last}")

    # -- responses --------------------------------------------------------

    def _respond(self, row: _Row, resp: Dict) -> None:
        if self.defunct:
            # A retired generation (bounce) never resolves: the new
            # generation owns these requests now — resolving here would
            # race the re-admitted run for the same Future.
            return
        if row.request.get("id") is not None:
            resp.setdefault("id", row.request["id"])
        if resp["status"] != "ok" and self.retry is not None and \
                self.retry(row.request, resp):
            # Re-admitted under the retry budget: the trace stays open
            # (the retry attempt appends to the same timeline) and the
            # Future resolves with the retried attempt's response.
            return
        row.trace.finish(status=resp["status"], code=resp.get("code"),
                         quality=resp.get("quality"))
        self.resolve(row.request, resp)

    def _finish(self, row: _Row, flow_padded: np.ndarray, now: float) -> None:
        if self.defunct:
            return  # retired generation: don't even count the attempt
        session = self.session
        with row.trace.span("unpad"):
            flow = row.padder.unpad_np(flow_padded)[0, ..., 0]
        if row.iters_done >= session.cfg.valid_iters:
            quality = "full"
        elif row.converged:
            # k is the iterations this row ran; a near-tier seed says so.
            quality = (f"warm:cache:{row.iters_done}" if row.cache_warm
                       else f"converged:{row.iters_done}")
        else:
            quality = f"reduced_iters:{row.iters_done}"
        if flow.shape != (row.orig_h, row.orig_w):
            session.count_request(ok=False)
            self._respond(row, _error(
                "internal", f"output shape {flow.shape} != input "
                f"({row.orig_h}, {row.orig_w})"))
            return
        if not np.isfinite(flow).all():
            session.count_request(ok=False, nonfinite=True)
            self._respond(row, _error(
                "nonfinite_output",
                "disparity contains NaN/Inf — refusing to serve it"))
            return
        session.count_request(ok=True, degraded=quality != "full")
        self._respond(row, {
            "status": "ok",
            "quality": quality,
            "disparity": -flow,
            "iters": row.iters_done,
            "elapsed_ms": (now - row.t_start) * 1e3,
            "deadline_missed": (row.deadline is not None
                                and now > row.deadline),
        })

    @staticmethod
    def _bucket_rows(bucket: _Bucket) -> List[_Row]:
        """Every row the bucket currently owns — active, mid-prepare
        (``joining``), and still-pending — deduped by identity (a row is
        in both ``rows`` and ``joining`` for the instants between the
        join merge and the ``joining`` reset)."""
        seen = set()
        out: List[_Row] = []
        for row in (list(bucket.rows) + list(bucket.joining)
                    + list(bucket.pending)):
            if id(row) not in seen:
                seen.add(id(row))
                out.append(row)
        return out

    def _fail_bucket(self, bucket: _Bucket, exc: Exception) -> None:
        """Terminal tick failure: every request in the bucket gets a
        structured error (never an abandoned Future), the bucket resets."""
        if self.defunct:
            return  # harvest() owns these rows; a zombie's failure is moot
        code = exc.code if isinstance(exc, SessionError) else "internal"
        for row in self._bucket_rows(bucket):
            # Mirror the sequential path's accounting (infer() increments
            # requests_failed on every exception): /healthz session
            # counters stay one truth across serving modes.
            self.session.count_request(ok=False)
            self._respond(row, _error(
                code, f"batched tick failed: {exc}"))
        bucket.rows = []
        bucket.joining = []
        bucket.carry = None
        bucket.pending.clear()

    def drain_pending(self, code: str = "service_stopped",
                      message: str = "service stopped before this request "
                                     "ran") -> None:
        """Reject joiners that never made it into a batch (shutdown path:
        active rows keep ticking to their segment-boundary exits — they
        already own device state — while un-admitted work is returned with
        the same structured rejection the sequential stop() uses)."""
        for bucket in self._bucket_list():
            while bucket.pending:
                self._respond(bucket.pending.popleft(),
                              _reject(code, message))

    def drain(self, code: str = "service_stopped",
              message: str = "service stopped before this request ran"
              ) -> None:
        """Reject everything still waiting or mid-flight (hard shutdown)."""
        self.drain_pending(code, message)
        for bucket in self._bucket_list():
            for row in list(bucket.rows) + list(bucket.joining):
                self._respond(row, _reject(code, message))
            bucket.rows = []
            bucket.joining = []
            bucket.carry = None
        self.shutdown()

    def shutdown(self) -> None:
        self.uploader.stop()

    # -- supervision (serve/supervise.py) ----------------------------------

    def inflight_requests(self) -> List[Dict]:
        """Request dicts of every row currently riding this scheduler
        (active + pending joiners), read-only — the drain path stamps
        decision events on their timelines."""
        return [row.request for bucket in self._bucket_list()
                for row in self._bucket_rows(bucket)]

    def harvest(self) -> List[Dict]:
        """Generation bounce: strip every admitted request (active rows
        + pending joiners) out of the batch state and return their
        request dicts for re-admission — original host inputs are still
        held on each dict, so nothing is silently dropped.

        Call ONLY after ``defunct`` is set and this generation's stop
        event fired: a zombie thread waking from a hung device call
        checks ``defunct`` behind every device call (discarding its
        results), its loop exits immediately, and its ``_respond``
        discards instead of double-resolving.  The ``joining`` group —
        rows mid-batched-prepare, already popped from ``pending`` — is
        harvested too: a hung prepare must strand nothing.  Device-side
        carries are abandoned with the generation; re-admitted rows
        re-upload from host."""
        out: List[Dict] = []
        for bucket in self._bucket_list():
            rows = self._bucket_rows(bucket)
            bucket.rows = []
            bucket.joining = []
            bucket.pending.clear()
            bucket.carry = None
            out.extend(row.request for row in rows)
        self.shutdown()
        return out

    # -- reporting --------------------------------------------------------

    def status(self) -> Dict:
        """The /healthz "batching" document — every aggregate is a
        registry read (same series /metrics exposes)."""
        ticks = int(self._m_ticks.value)
        joins = int(self._m_joins.value)
        exits = int(self._m_exits.value)
        pad_rows = int(self._m_pad_rows.value)
        batch_rows = int(self._m_batch_rows.value)
        occ = {labels["rows"]: int(v) for labels, v in self.registry.series(
            "raft_sched_occupancy_total")}
        occ = {k: occ[k] for k in sorted(occ, key=int)}
        by_bucket = {labels["b"]: int(v) for labels, v in self.registry.series(
            "raft_sched_bucket_ticks_total")}
        by_bucket = {k: by_bucket[k] for k in sorted(by_bucket, key=int)}

        def pct(p: float) -> Optional[float]:
            v = self._tick_hist.percentile(p)
            return None if v is None else v * 1e3

        denom = max(1, ticks)
        return {
            "max_batch": self.session.cfg.max_batch,
            "batch_buckets": list(self.session.batch_buckets),
            "active": self.active_rows,
            "pending": sum(len(b.pending) for b in self._bucket_list()),
            "ticks": ticks,
            "joins": joins,
            "exits": exits,
            "joins_per_tick": joins / denom,
            "exits_per_tick": exits / denom,
            "occupancy_hist": occ,
            "ticks_by_bucket": by_bucket,
            "pad_waste": (pad_rows / batch_rows if batch_rows else 0.0),
            "tick_latency_ms": {"p50": pct(0.50), "p99": pct(0.99),
                                "n": self._tick_hist.n},
        }
