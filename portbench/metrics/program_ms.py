"""Median over the window's requests of the summed spans of the session's
programs a request rode (``prepare`` + ``advance`` + ``epilogue``, or
``full``; ``RAFT_TRACE`` sink)."""

import statistics

KINDS = ("prepare", "advance", "epilogue", "full")


def read(rec):
    sums = [sum(s["ms"] for s in r["spans"]
                if s["kind"] in KINDS and not s.get("attrs", {}).get("warming"))
            for r in rec.get("requests") or ()]
    return statistics.median(sums) if sums else None
