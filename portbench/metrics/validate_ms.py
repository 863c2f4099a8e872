"""Median over the window's requests of their ``validate`` span (the
service's input check at admission, in the submitting thread; ``RAFT_TRACE``
sink). None where the program records no such span."""

import statistics


def read(rec):
    ms = [sum(s["ms"] for s in spans) for spans in
          ([s for s in r["spans"] if s["kind"] == "validate"]
           for r in rec.get("requests") or ()) if spans]
    return statistics.median(ms) if ms else None
