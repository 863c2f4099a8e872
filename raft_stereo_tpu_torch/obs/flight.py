"""SLO flight recorder: when a request goes wrong, leave an artifact.

A copy of the JAX package's ``obs/flight.py``.

A p99 blowup, a breaker trip or a non-finite output on a live server
used to leave nothing behind but a counter increment — by the time an
operator looks, the ring buffer has rotated and the request's timeline
is gone.  The flight recorder persists a bounded set of **flight
records**: one JSON file per SLO-breaching request, written at response
resolution time by the service, containing

- the request's full graftscope span timeline (``obs/tracing.py``),
  degrade/breaker decision events included;
- the ledger rows of every program the request touched (spans carry the
  program's ledger id — see ``obs/ledger.py``);
- a registry snapshot and the breaker state at breach time;
- the response summary and the breach reason(s).

Contract (mirrors the ``RAFT_TRACE`` sink):

- armed by ``RAFT_FLIGHT_DIR`` (read ONCE, at construction — GL001's
  import-time class cannot recur) or an explicit argument; unarmed, every
  ``record()`` is a counted no-op;
- **bounded**: at most ``limit`` records live in the directory; the
  oldest (by the monotonic sequence number in the filename, which
  continues across restarts) are evicted first;
- **failure-isolated**: a sink failure (bad path, disk full) logs once,
  disables the recorder and never escapes into the serving thread — an
  exception here would kill the batch scheduler and hang every pending
  Future.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

#: Default bound on persisted flight records: enough to cover an incident
#: window, bounded regardless of how badly the SLO is burning.
DEFAULT_LIMIT = 32

_FLIGHT_RE = re.compile(r"^flight-(\d{6})-.*\.json$")


class FlightRecorder:
    def __init__(self, out_dir: Optional[str] = None, *,
                 limit: int = DEFAULT_LIMIT):
        if out_dir is None:
            out_dir = os.environ.get("RAFT_FLIGHT_DIR") or None
        if limit < 1:
            raise ValueError(f"flight-record limit must be >= 1, "
                             f"got {limit}")
        self._dir = out_dir
        self._limit = limit
        self._recorded = 0
        self._skipped = 0
        self._evicted = 0
        self._lock = threading.Lock()
        # Continue the sequence past any records a previous process left:
        # eviction order must stay oldest-first across restarts.
        self._seq = self._scan_seq() if out_dir else 0

    def _scan_seq(self) -> int:
        try:
            names = os.listdir(self._dir)
        except OSError:
            return 0
        seqs = [int(m.group(1)) for m in map(_FLIGHT_RE.match, names) if m]
        return max(seqs) + 1 if seqs else 0

    @property
    def enabled(self) -> bool:
        return self._dir is not None

    def record(self, doc: Dict, *, trace_id: Optional[str] = None
               ) -> Optional[str]:
        """Persist one flight record; returns its path, or ``None`` when
        unarmed or the sink just failed.  Never raises."""
        with self._lock:
            if self._dir is None:
                self._skipped += 1
                return None
            seq = self._seq
            self._seq += 1
            out_dir = self._dir
        name = f"flight-{seq:06d}-{trace_id or 'untraced'}.json"
        path = os.path.join(out_dir, name)
        try:
            os.makedirs(out_dir, exist_ok=True)
            tmp = path + ".tmp"
            # Flight records are written from the watchdog's bounce path
            # under _check_lock on purpose: the record must land before
            # the sweep releases (a crash right after the bounce must
            # not lose the evidence), the doc is byte-capped, and
            # _check_lock only serializes sweeps — the serving path
            # never waits on it.
            # graftlint: disable=GC204 (bounded flight dump on the watchdog path, not the serving path)
            with open(tmp, "w") as f:
                # graftlint: disable=GC204 (same bounded watchdog-path dump)
                json.dump(doc, f, default=str, sort_keys=True, indent=1)
                f.write("\n")
            # graftlint: disable=GC204 (atomic publish of the same dump)
            os.replace(tmp, path)
            self._evict(out_dir)
        except Exception:  # noqa: BLE001 — the telemetry/serving boundary
            logger.exception(
                "flight-record sink %s failed — disabling the recorder "
                "(serving continues, no further records)", out_dir)
            with self._lock:
                self._dir = None
            return None
        with self._lock:
            self._recorded += 1
        return path

    def _evict(self, out_dir: str) -> None:
        entries = sorted(n for n in os.listdir(out_dir)
                         if _FLIGHT_RE.match(n))
        excess = len(entries) - self._limit
        for name in entries[:max(0, excess)]:
            try:
                os.remove(os.path.join(out_dir, name))
                with self._lock:
                    self._evicted += 1
            except OSError:
                pass  # already gone (concurrent cleanup) — not a failure

    def records(self) -> List[str]:
        """Paths of the currently persisted records, oldest first."""
        with self._lock:
            out_dir = self._dir
        if out_dir is None:
            return []
        try:
            return [os.path.join(out_dir, n)
                    for n in sorted(os.listdir(out_dir))
                    if _FLIGHT_RE.match(n)]
        except OSError:
            return []

    def status(self) -> Dict:
        with self._lock:
            return {"enabled": self._dir is not None, "dir": self._dir,
                    "limit": self._limit, "recorded": self._recorded,
                    "evicted": self._evicted, "skipped": self._skipped}
