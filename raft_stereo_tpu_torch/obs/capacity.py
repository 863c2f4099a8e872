"""Capacity & saturation model — how far is this service from the wall?

A copy of the JAX package's ``obs/capacity.py``.

The scheduler's EMA cost table (per (program, batch bucket), warmed
steady-state only) already knows what one tick costs; the deck
(obs/deck.py) knows how busy the device has actually been.  This module
turns those two trusted sources into the operator numbers the pod-scale
and MFU arcs will be steered by:

- **per-bucket theoretical requests/s**: a full-quality request costs
  ``prepare + segments x advance + epilogue`` at some batch bucket
  ``b``, amortized across the ``b`` rows riding it — so the bucket's
  ceiling is ``b / (e_prep + segments * e_adv + e_epi)``.  Every batch
  bucket with a warmed advance estimate is scored and the best wins
  (sequential deployments score ``1 / e_full`` the same way).  Missing
  estimates make the component 0 and flag the row ``partial`` — an
  honest under-informed ceiling, never a fabricated one; a bucket with
  no advance/full estimate at all reports ``None``;
- **live saturation**: device-busy fraction over a sliding window
  (default 60 s, ``RAFT_CAPACITY_WINDOW_MS``) computed from the deck's
  per-record steady+warm device seconds vs wall time — 1.0 means the
  device never idled, the distance to 1.0 is the admission headroom;
- **headroom gauges**: ``raft_capacity_headroom{bucket=}`` publishes
  ``theoretical_rps x (1 - saturation)`` — requests/s of remaining
  capacity — plus ``raft_capacity_saturation``; the same document rides
  ``/healthz`` (``capacity`` block) and the serve bench emits it into
  ``TRAJECTORY.json`` so gate runs pin predicted-vs-measured
  requests/s side by side.

Pure functions over plain rows — stdlib-only, no jax, no session import
(the session adapts its estimate table into ``rows``)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

SCHEMA = 1

#: Default saturation sliding window.
DEFAULT_WINDOW_S = 60.0


def resolve_capacity_window_s(value: Optional[float] = None) -> float:
    """Effective saturation window in seconds: explicit config wins,
    else ``RAFT_CAPACITY_WINDOW_MS``, else 60 s.  Telemetry windowing
    only (HOST_ENV_KNOBS) — no compiled program depends on it."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_CAPACITY_WINDOW_MS", "").strip()
    if not raw:
        return DEFAULT_WINDOW_S
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError(
            f"RAFT_CAPACITY_WINDOW_MS must be a number, "
            f"got {raw!r}") from None
    if ms <= 0:
        raise ValueError(
            f"RAFT_CAPACITY_WINDOW_MS must be positive, got {ms}")
    return ms / 1e3


def model(rows: List[Dict], *, segments: int,
          valid_iters: int) -> Dict:
    """Theoretical requests/s per shape bucket from warmed EMA rows.

    ``rows``: ``[{kind, b, h, w, iters, est}]`` — the session's latency
    EMA table (steady-state seconds per invocation, warmups excluded by
    construction).  Returns ``{"by_bucket": {...}, "best_rps": ...}``.
    """
    by_shape: Dict[str, Dict] = {}
    for r in rows:
        bucket = f"{r['h']}x{r['w']}"
        by_shape.setdefault(bucket, {})[(r["kind"], r["b"])] = r["est"]

    out: Dict[str, Dict] = {}
    for bucket, ests in by_shape.items():
        candidates: List[Dict] = []
        # Batched serving: score every batch bucket with an advance EMA.
        for (kind, b), e_adv in ests.items():
            if kind != "advance" or e_adv is None:
                continue
            e_prep = ests.get(("prepare", b))
            e_epi = ests.get(("epilogue", b))
            per_batch = ((e_prep or 0.0) + segments * e_adv
                         + (e_epi or 0.0))
            if per_batch <= 0:
                continue
            candidates.append({
                "mode": "batched", "batch": b,
                "rps": b / per_batch,
                "seconds_per_request": per_batch / b,
                "partial": e_prep is None or e_epi is None,
                "components": {"prepare": e_prep,
                               "advance_per_segment": e_adv,
                               "epilogue": e_epi,
                               "segments": segments},
            })
        # Sequential serving: the single-scan full program...
        e_full = ests.get(("full", 1))
        if e_full:
            candidates.append({
                "mode": "sequential", "batch": 1, "rps": 1.0 / e_full,
                "seconds_per_request": e_full, "partial": False,
                "components": {"full": e_full},
            })
        # ...or the segmented prepare + k x segment path.
        e_seg = ests.get(("segment", 1))
        if e_seg:
            e_prep = ests.get(("prepare", 1))
            per_req = (e_prep or 0.0) + segments * e_seg
            candidates.append({
                "mode": "sequential_segmented", "batch": 1,
                "rps": 1.0 / per_req, "seconds_per_request": per_req,
                "partial": e_prep is None,
                "components": {"prepare": e_prep,
                               "segment_per_segment": e_seg,
                               "segments": segments},
            })
        best = max(candidates, key=lambda c: c["rps"], default=None)
        out[bucket] = (dict(best) if best is not None
                       else {"mode": None, "rps": None, "partial": True,
                             "components": {}})
    best_rps = max((m["rps"] for m in out.values()
                    if m["rps"] is not None), default=None)
    return {"schema": SCHEMA, "segments": segments,
            "valid_iters": valid_iters, "by_bucket": out,
            "best_rps": best_rps}


def saturation(deck_rows: List[Dict], *, now: float,
               window_s: float = DEFAULT_WINDOW_S) -> Optional[Dict]:
    """Device-busy fraction over the sliding window, from deck records.

    Busy time is each record's steady ``device_s`` plus compile-inclusive
    ``warm_s`` (a compiling device is not idle), clipped proportionally
    where a record straddles the window edge.  The denominator is the
    window span actually covered by history (``min(window, now - first
    record)``), so a young server is not diluted to near-zero.  Returns
    ``None`` when there is no history — absence, never a fabricated 0.

    With CONCURRENT submitters (sequential mode, ``workers >= 2``) the
    host-measured device intervals of different threads can overlap
    even though the one device serializes them, so the raw busy sum can
    exceed the wall window.  ``ratio`` is clamped to 1.0 — a saturation
    gauge must keep its "distance to 1.0 is the headroom" meaning — and
    the unclamped evidence stays visible as ``busy_s`` / ``covered_s``.
    """
    w0 = now - window_s
    busy = 0.0
    earliest: Optional[float] = None
    for t in deck_rows:
        t1 = t.get("t_end")
        if t1 is None or t1 <= w0:
            continue
        t0 = min(t["t_start"], t1)
        if earliest is None or t0 < earliest:
            earliest = t0
        span = t1 - t0
        frac = 1.0
        if span > 0:
            frac = max(0.0, min(t1, now) - max(t0, w0)) / span
        busy += (t.get("device_s", 0.0) + t.get("warm_s", 0.0)) * frac
    if earliest is None:
        return None
    covered = min(window_s, max(1e-12, now - max(earliest, w0)))
    return {"ratio": min(1.0, busy / covered), "busy_s": busy,
            "window_s": window_s, "covered_s": covered}


def headroom_recovered(pre: Optional[float], post: Optional[float], *,
                       tol: float = 0.10) -> Optional[bool]:
    """graftheal's recovery acceptance test as arithmetic: did summed
    ``headroom_rps`` return to within ``tol`` of its pre-fault value
    after a re-admission?  ``None`` in = ``None`` out (capacity EMAs
    not warmed — absence, never a fabricated verdict); a zero pre-fault
    headroom recovers trivially (there was nothing to restore).  Shared
    by the chaos storms and the release-gate trajectory extras so the
    in-test and in-gate definitions of "recovered" cannot drift."""
    if pre is None or post is None:
        return None
    if pre <= 0:
        return True
    return post >= pre * (1.0 - tol)


def saturation_per_chip(deck_rows: List[Dict], n_chips: int, *, now: float,
                        window_s: float = DEFAULT_WINDOW_S) -> List[Dict]:
    """Per-chip device-busy fractions over the sliding window (graftpod).

    A mesh invocation's device window covers ALL of its chips at once
    (one wall interval, the deck's reconciliation contract — never
    multiplied by the span), so each record's ``device_s + warm_s``
    counts toward chips ``0 .. chips-1``: the mesh always packs the
    leading chips of the device list, so a 2-chip record busies chips 0
    and 1 while chips 2+ idle.  Same window-edge clipping and covered
    denominator as :func:`saturation`; a chip with no history reports
    ``ratio: None`` — absence, never a fabricated 0.
    """
    w0 = now - window_s
    busy = [0.0] * max(1, int(n_chips))
    earliest = [None] * max(1, int(n_chips))
    for t in deck_rows:
        t1 = t.get("t_end")
        if t1 is None or t1 <= w0:
            continue
        t0 = min(t["t_start"], t1)
        span = t1 - t0
        frac = 1.0
        if span > 0:
            frac = max(0.0, min(t1, now) - max(t0, w0)) / span
        dt = (t.get("device_s", 0.0) + t.get("warm_s", 0.0)) * frac
        for chip in range(min(len(busy), max(1, int(t.get("chips", 1))))):
            busy[chip] += dt
            if earliest[chip] is None or t0 < earliest[chip]:
                earliest[chip] = t0
    out: List[Dict] = []
    for chip in range(len(busy)):
        if earliest[chip] is None:
            out.append({"chip": chip, "ratio": None, "busy_s": 0.0})
            continue
        covered = min(window_s,
                      max(1e-12, now - max(earliest[chip], w0)))
        out.append({"chip": chip,
                    "ratio": min(1.0, busy[chip] / covered),
                    "busy_s": busy[chip]})
    return out
