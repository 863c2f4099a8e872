"""graftdeck — the tick flight-deck: what did each scheduler tick DO?

A copy of the JAX package's ``obs/deck.py``.

The telemetry built so far answers "how long did this request take"
(tracing), "what did this program cost" (ledger) and "did we breach"
(flight) — but nothing records what the *scheduler* actually did tick by
tick, which is exactly where continuous-batching throughput goes to die:
partial batches, pad-row waste, idle gaps between ticks.  This module is
the operator-plane record of that loop:

- a **bounded ring** (default 1024, ``RAFT_DECK_TICKS``) of per-tick
  :class:`TickRecord` rows owned by the scheduler thread: tick seq,
  shape bucket, batch size, live-row occupancy, joins/exits/pad rows,
  the advance program's ledger id, steady host/device seconds (split
  exactly as ``raft_program_*_seconds_total`` splits them — the deck's
  per-tick device seconds reconcile with the counters and the trace
  span timeline, three-way and exactly under FakeClock), queue depth at
  tick start, and the scheduler generation;
- **sequential mode records too**: an invocation outside any open tick
  (the worker-pool path, direct ``session.infer``) lands as its own
  standalone row, so the reconciliation contract holds in both serving
  modes;
- ``GET /debug/ticks`` serves :meth:`TickDeck.doc` (bounded JSON), and
  ``python -m raft_stereo_tpu_torch.obs.deck report`` renders the operator
  views offline: occupancy histogram, pad-waste by bucket, and the
  idle-gap analysis between ticks (the number that says whether the
  chip is starved by the host or busy);
- flight records link back here by **tick-seq range**: the scheduler
  stamps ``tick=<seq>`` on every fanned device span, so an SLO
  post-mortem names the exact ticks the request rode;
- :func:`thread_stacks` is the live-introspection partner of the hang
  watchdogs (``GET /debug/stacks``): an all-thread stack dump via
  ``sys._current_frames`` that names a hung invocation's parked frame
  while the watchdog is still counting down.

Threading contract: ``begin_tick``/``end_tick`` bracket one scheduler
tick on the calling thread (the open tick is thread-local, so a zombie
generation's tick can never corrupt a fresh generation's record);
``note_invocation`` accumulates into the calling thread's open tick or
appends a standalone row.  The ring itself is lock-guarded for the
``/debug/ticks`` readers.

Stdlib-only, no jax — importable from the linter's environment.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
from collections import deque
from typing import Dict, List, Optional

SCHEMA = 1

#: Default ring depth: at a few ticks per second this covers minutes of
#: scheduler history, bounded regardless of traffic.
DEFAULT_DECK_TICKS = 1024


def resolve_deck_ticks(value: Optional[int] = None) -> int:
    """Effective deck ring depth: explicit config wins, else
    ``RAFT_DECK_TICKS``, else 1024.  Telemetry sizing only (the
    HOST_ENV_KNOBS rationale) — no compiled program depends on it.
    A malformed value raises a ValueError NAMING the variable (the
    SLURM_CPUS_PER_TASK convention)."""
    if value is not None:
        return int(value)
    raw = os.environ.get("RAFT_DECK_TICKS", "").strip()
    if not raw:
        return DEFAULT_DECK_TICKS
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"RAFT_DECK_TICKS must be an integer, got {raw!r}") from None
    if n < 1:
        raise ValueError(f"RAFT_DECK_TICKS must be >= 1, got {n}")
    return n


@dataclasses.dataclass
class TickRecord:
    """One scheduler tick (``kind='tick'``) or one standalone sequential
    invocation (``kind=<program kind>``).  Time fields are SESSION-clock
    seconds; ``device_s``/``host_s`` cover steady invocations only and
    ``warm_s`` the compile-inclusive warming ones — the same split the
    ``raft_program_*_seconds_total`` counters use, which is what makes
    the three-way reconciliation an equality rather than a tolerance."""

    seq: int
    kind: str                      # 'tick' | program kind (standalone)
    t_start: float
    t_end: Optional[float] = None
    bucket: Optional[str] = None   # padded shape, "HxW"
    generation: Optional[int] = None
    queue_depth: Optional[int] = None  # pending joiners at tick start
    batch: int = 0                 # advance batch bucket (rows incl. pads)
    occupancy: int = 0             # live rows advanced
    joins: int = 0
    warm_joins: int = 0            # joins seeded via prepare_warm
    exits: int = 0
    converged: int = 0             # exits via the convergence monitor
    cache_hits: int = 0            # CUMULATIVE response-cache hits
    #                                (exact + near) at tick start — diff
    #                                two rows for the hit rate over a
    #                                window (graftrecall, serve/cache.py)
    pad_rows: int = 0
    iters: int = 0                 # refinement iters this tick advanced
    program: Optional[str] = None  # advance program's ledger id
    invocations: int = 0           # device calls inside this record
    chips: int = 1                 # mesh chips the device calls spanned
    #                                (graftpod; device_s stays the ONE
    #                                wall interval per invoke, never
    #                                multiplied by chips — the per-chip
    #                                view divides, obs/capacity.py)
    host_s: float = 0.0
    device_s: float = 0.0
    warm_s: float = 0.0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class TickDeck:
    """Bounded ring of :class:`TickRecord` rows + the thread-local
    open-tick accumulator the scheduler drives."""

    def __init__(self, clock=None, ticks: Optional[int] = None):
        if clock is None:
            from raft_stereo_tpu_torch.faults import RealClock
            clock = RealClock()
        self._clock = clock
        self._ring_size = resolve_deck_ticks(ticks)
        self._ring: "deque[TickRecord]" = deque(maxlen=self._ring_size)
        self._seq = 0
        self._closed = 0   # records actually published to the ring —
        #                    dropped = closed - ringed, so an OPEN tick
        #                    (seq allocated, not yet ringed) can never
        #                    read as a spurious ring drop
        self._warm = 0     # CUMULATIVE records that carried compile-
        #                    inclusive warm time — monotone (unlike a
        #                    ring scan, which forgets as rows fall off),
        #                    so graftheal's "zero mid-request compiles
        #                    across a re-grow" pin is a two-read diff
        self._lock = threading.Lock()
        self._tl = threading.local()

    # -- recording ---------------------------------------------------------

    def _next_seq(self) -> int:
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
        return seq

    def begin_tick(self, *, bucket: str, generation: Optional[int] = None,
                   queue_depth: Optional[int] = None) -> TickRecord:
        """Open one scheduler tick on the calling thread.  The record is
        private to this thread until :meth:`end_tick` publishes it to the
        ring, so /debug/ticks readers never see a half-written row."""
        rec = TickRecord(seq=self._next_seq(), kind="tick",
                         t_start=self._clock.now(), bucket=bucket,
                         generation=generation, queue_depth=queue_depth)
        self._tl.open = rec
        return rec

    def end_tick(self, rec: TickRecord) -> None:
        rec.t_end = self._clock.now()
        if getattr(self._tl, "open", None) is rec:
            self._tl.open = None
        with self._lock:
            self._ring.append(rec)
            self._closed += 1
            if rec.warm_s > 0:
                self._warm += 1

    def current(self) -> Optional[TickRecord]:
        """The calling thread's open tick, if any (the session's invoke
        uses this to decide tick-accumulate vs standalone row)."""
        return getattr(self._tl, "open", None)

    def note_invocation(self, *, kind: str, program: str, b: int, h: int,
                        w: int, t0: float, t1: float, host_s: float,
                        device_s: float, warming: bool,
                        chips: int = 1) -> Optional[int]:
        """One device invocation's timing.  Inside an open tick (the
        scheduler thread) it accumulates; outside (sequential workers,
        direct ``session.infer``) it records a standalone row and
        returns its seq so the caller can stamp ``tick=<seq>`` on the
        matching trace span.  ``chips`` is the mesh span of THIS
        invocation; an open tick takes the max (all of one tick's calls
        ride one mesh, but a quarantine between programs must surface
        the wider span, never hide it)."""
        open_tick = getattr(self._tl, "open", None)
        if open_tick is not None:
            open_tick.invocations += 1
            open_tick.chips = max(open_tick.chips, int(chips))
            if warming:
                open_tick.warm_s += host_s + device_s
            else:
                open_tick.host_s += host_s
                open_tick.device_s += device_s
            return None
        rec = TickRecord(seq=self._next_seq(), kind=kind, t_start=t0,
                         t_end=t1, bucket=f"{h}x{w}", batch=b,
                         occupancy=b, program=program, invocations=1,
                         chips=int(chips))
        if warming:
            rec.warm_s = host_s + device_s
        else:
            rec.host_s = host_s
            rec.device_s = device_s
        with self._lock:
            self._ring.append(rec)
            self._closed += 1
            if rec.warm_s > 0:
                self._warm += 1
        return rec.seq

    # -- reporting ---------------------------------------------------------

    def snapshot(self, n: Optional[int] = None) -> List[Dict]:
        """The newest ``n`` (default: all ringed) completed records,
        oldest first — the bounded /debug/ticks payload."""
        with self._lock:
            rows = list(self._ring)
        if n is not None:
            rows = rows[-max(1, int(n)):]
        return [r.to_dict() for r in rows]

    def status(self) -> Dict:
        with self._lock:
            ringed = len(self._ring)
            recorded = self._seq
            closed = self._closed
            warm = self._warm
        return {"ring": self._ring_size, "recorded": recorded,
                "dropped": max(0, closed - ringed),
                "warm_records": warm}

    def doc(self, n: Optional[int] = None) -> Dict:
        """The /debug/ticks document: bounded by construction (the ring)
        and further by ``n``."""
        return {"schema": SCHEMA, **self.status(),
                "ticks": self.snapshot(n)}


# ---------------------------------------------------------------------------
# Live debug introspection: all-thread stack dump (GET /debug/stacks).
# ---------------------------------------------------------------------------

#: Bounds on the stack dump — the endpoint must stay cheap and bounded
#: even on a process with many handler threads and deep stacks.
STACKS_MAX_THREADS = 64
STACKS_MAX_FRAMES = 32


def thread_stacks(max_threads: int = STACKS_MAX_THREADS,
                  max_frames: int = STACKS_MAX_FRAMES) -> Dict:
    """Bounded all-thread stack dump via ``sys._current_frames`` — the
    natural partner of the hang watchdogs: while a hung device
    invocation is still inside its deadline, this names the exact frame
    the victim thread is parked in (acceptance-pinned against an
    injected device hang).  Read-only: no thread is interrupted, the
    frames are snapshotted and immediately released."""
    import traceback
    names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
    frames = sys._current_frames()
    n_threads = len(frames)
    threads: List[Dict] = []
    try:
        for ident, frame in list(frames.items())[:max_threads]:
            name, daemon = names.get(ident, (None, None))
            stack = traceback.extract_stack(frame)[-max_frames:]
            threads.append({
                "ident": ident,
                "name": name,
                "daemon": daemon,
                "current": ident == threading.get_ident(),
                "frames": [{"file": f.filename, "line": f.lineno,
                            "function": f.name} for f in stack],
            })
    finally:
        del frames  # drop the frame references promptly
    return {"schema": SCHEMA, "thread_count": n_threads,
            "truncated": n_threads > max_threads,
            "threads": threads}


# ---------------------------------------------------------------------------
# Report CLI: `python -m raft_stereo_tpu_torch.obs.deck report <doc.json|URL|->`
# ---------------------------------------------------------------------------


class DeckError(ValueError):
    """Malformed deck document — the CLI maps this to exit 2 (a corrupt
    dump can never read as a clean report)."""


def _load_doc(target: str) -> Dict:
    try:
        if target == "-":
            raw = sys.stdin.read()
        elif target.startswith(("http://", "https://")):
            from urllib.request import urlopen
            with urlopen(target, timeout=10) as resp:
                raw = resp.read().decode("utf-8")
        else:
            with open(target) as f:
                raw = f.read()
    except OSError as e:
        raise DeckError(f"cannot read {target}: {e}") from e
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise DeckError(f"{target} is not valid JSON: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("ticks"), list):
        raise DeckError(
            f"{target} is not a deck document "
            "({'schema': 1, 'ticks': [...]} — save GET /debug/ticks)")
    for t in doc["ticks"]:
        if not isinstance(t, dict) or "seq" not in t or "t_start" not in t:
            raise DeckError(f"malformed tick record: {t!r}")
    return doc


def _pct(sample: List[float], p: float) -> Optional[float]:
    if not sample:
        return None
    s = sorted(sample)
    return s[min(len(s) - 1, int(p * len(s)))]


def report(doc: Dict, out=None) -> Dict:
    """Render the operator views of one deck document and return the
    computed summary (the CLI prints; tests assert on the dict)."""
    out = out or sys.stdout
    ticks = [t for t in doc["ticks"] if t.get("kind") == "tick"]
    standalone = [t for t in doc["ticks"] if t.get("kind") != "tick"]
    print(f"deck: {len(doc['ticks'])} record(s) "
          f"({len(ticks)} scheduler tick(s), {len(standalone)} "
          f"standalone invocation(s)), {doc.get('dropped', 0)} older "
          f"dropped from the ring", file=out)

    # Occupancy histogram: live rows per advancing tick.  Every field
    # read below is .get-defaulted: a hand-trimmed or future-schema doc
    # must degrade to partial output, never a KeyError traceback that
    # escapes the DeckError -> rc 2 contract.
    occ: Dict[int, int] = {}
    for t in ticks:
        if t.get("batch", 0) > 0:
            rows_live = int(t.get("occupancy", 0))
            occ[rows_live] = occ.get(rows_live, 0) + 1
    total_adv = sum(occ.values())
    print("occupancy histogram (live rows -> ticks):", file=out)
    for rows in sorted(occ):
        frac = occ[rows] / total_adv
        print(f"  {rows:4d}: {occ[rows]:6d}  {'#' * int(40 * frac)}",
              file=out)
    if not occ:
        print("  (no advancing ticks recorded)", file=out)
    occ_mean = (sum(r * c for r, c in occ.items()) / total_adv
                if total_adv else None)

    # Pad waste by shape bucket: dead rows / total rows advanced.
    waste: Dict[str, List[int]] = {}
    for t in ticks:
        if t.get("batch", 0) > 0:
            w = waste.setdefault(str(t.get("bucket")), [0, 0])
            w[0] += t.get("pad_rows", 0)
            w[1] += t.get("batch", 0)
    print("pad waste by bucket (pad rows / batch rows):", file=out)
    for bucket in sorted(waste):
        pads, rows = waste[bucket]
        print(f"  {bucket}: {pads}/{rows} = {pads / rows:.1%}", file=out)
    if not waste:
        print("  (no advancing ticks recorded)", file=out)

    # Mesh span (graftpod): ticks whose device calls rode a >1-chip mesh.
    mesh_ticks = [t for t in ticks if int(t.get("chips", 1)) > 1]
    if mesh_ticks:
        print(f"mesh ticks: {len(mesh_ticks)} of {len(ticks)} spanned "
              f"{max(int(t.get('chips', 1)) for t in mesh_ticks)} chip(s)",
              file=out)

    # Response-cache hit rate over the ring window (graftrecall):
    # cache_hits is cumulative at tick start, so last - first is the
    # hits served while these ticks ran.
    ch = [int(t.get("cache_hits", 0)) for t in ticks]
    cache_window = (ch[-1] - ch[0]) if len(ch) >= 2 else 0
    if any(ch):
        served = sum(t.get("exits", 0) for t in ticks)
        print(f"response-cache hits over the ring window: {cache_window} "
              f"(vs {served} computed exits"
              + (f", hit frac {cache_window / (cache_window + served):.1%}"
                 if cache_window + served else "") + ")", file=out)

    # Idle-gap analysis: host time between one tick's end and the next
    # tick's start — the is-the-chip-starved number.
    gaps: List[float] = []
    seq_sorted = sorted((t for t in ticks if t.get("t_end") is not None),
                        key=lambda t: t["t_start"])
    for prev, cur in zip(seq_sorted, seq_sorted[1:]):
        gaps.append(max(0.0, cur["t_start"] - prev["t_end"]))
    busy = sum((t["t_end"] - t["t_start"]) for t in seq_sorted)
    print("idle gaps between ticks:", file=out)
    if gaps:
        print(f"  n={len(gaps)}  total_idle={sum(gaps):.4f}s  "
              f"total_busy={busy:.4f}s  "
              f"idle_frac={sum(gaps) / max(1e-12, sum(gaps) + busy):.1%}",
              file=out)
        print(f"  p50={_pct(gaps, 0.5):.4f}s  p99={_pct(gaps, 0.99):.4f}s"
              f"  max={max(gaps):.4f}s", file=out)
    else:
        print("  (fewer than two completed ticks)", file=out)

    return {"occupancy_hist": {str(k): v for k, v in sorted(occ.items())},
            "occupancy_mean": occ_mean,
            "pad_waste": {b: (p / r if r else 0.0)
                          for b, (p, r) in waste.items()},
            "mesh_ticks": len(mesh_ticks),
            "cache_hits_window": cache_window,
            "idle_gaps": {"n": len(gaps), "total_s": sum(gaps),
                          "busy_s": busy}}


def _cmd_report(args) -> int:
    report(_load_doc(args.target))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_stereo_tpu_torch.obs.deck",
        description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser(
        "report",
        help="occupancy histogram, pad-waste by bucket, idle-gap "
             "analysis from a saved GET /debug/ticks document")
    r.add_argument("target",
                   help="path to a deck JSON document, an http(s) URL "
                        "(the live /debug/ticks endpoint), or '-' for "
                        "stdin")
    r.set_defaults(func=_cmd_report)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except DeckError as e:
        print(f"deck: internal error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
