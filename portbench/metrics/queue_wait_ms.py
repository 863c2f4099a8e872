"""Median over the window's requests of the ``queue_wait`` span (the
service's admission to a worker or the scheduler; ``RAFT_TRACE`` sink)."""

import statistics


def read(rec):
    waits = [sum(s["ms"] for s in r["spans"] if s["kind"] == "queue_wait")
             for r in rec.get("requests") or ()]
    return statistics.median(waits) if waits else None
