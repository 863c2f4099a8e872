"""Median over the window's requests of the host time that put their inputs
on the card: the ``copy_in_ms`` attributes of their program spans (the copy
into a program's buffers), warm-up calls aside, plus their ``upload`` span
(the scheduler's copy of a joining pair; ``RAFT_TRACE`` sink). None where
the program spans carry no ``copy_in_ms``."""

import statistics


def _copy_in(spans):
    split = [s["attrs"]["copy_in_ms"] for s in spans
             if "copy_in_ms" in s.get("attrs", {}) and not s["attrs"].get("warming")]
    if not split:
        return None
    return sum(split) + sum(s["ms"] for s in spans if s["kind"] == "upload")


def read(rec):
    ms = [v for v in (_copy_in(r["spans"]) for r in rec.get("requests") or ())
          if v is not None]
    return statistics.median(ms) if ms else None
