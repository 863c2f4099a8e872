"""Deadline-aware anytime degradation for the refinement scan.

A copy of the JAX package's ``serve/degrade.py``. In the port a "compiled"
program is a CUDA graph captured on the card (``serve/session.py``).

RAFT-Stereo's GRU refinement is an anytime algorithm: every iteration
yields a valid (progressively sharper) disparity field — the paper's
real-time mode simply runs fewer iterations. This module exploits that
for serving: a deadline-carrying request runs the scan as ``segments``
host-visible chunks (``raft_stereo_segment`` — the same compiled scan
body, bit-identical composition), checks the wall clock between chunks,
and returns the **best-so-far upsampled field with an honest quality
label** instead of timing out hard:

- ``full``              — every iteration ran within budget;
- ``reduced_iters:<k>`` — the budget expired mid-scan; k iterations'
                          refinement is what you got;
- ``half_res``          — the predicted cost of even one full-res segment
                          exceeded the remaining budget, so the pair ran
                          at half resolution (disparity scaled ×2 back to
                          the input geometry).

Segment-time predictions are per-program EMAs recorded by the session; a
segment always runs when no estimate exists yet (you cannot degrade on a
guess), so the very first request on a bucket may overshoot its deadline —
``deadline_missed`` reports that honestly. A response is never fabricated:
whatever field is returned came out of the real refinement.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from raft_stereo_tpu_torch.obs.tracing import NULL_TRACE
from raft_stereo_tpu_torch.ops.padder import InputPadder

# Predicted-time inflation: stop one segment EARLY when the prediction is
# within 15% of the remaining budget rather than overshoot by a whole
# segment (EMAs smooth over compile-warm jitter, not eliminate it).
SAFETY = 1.15


@dataclasses.dataclass
class Outcome:
    """What a (possibly degraded) refinement produced, pre-unpad."""

    flow_padded: np.ndarray   # (1, H, W, 1); for half_res: already restored
    quality: str
    iters: int
    deadline_missed: bool


def _segment_plan(session) -> Tuple[int, int]:
    segments = session.cfg.segments
    return segments, session.cfg.valid_iters // segments


def warm_segmented(session, padder: InputPadder, zeros: np.ndarray) -> None:
    """Pre-compile the prepare/segment programs for one bucket — and, when
    half-res degradation is allowed, for its half bucket too (the policy
    only ever routes onto warm half-res programs; a cold one would trade a
    blown budget for a compile that dwarfs it)."""
    _, m = _segment_plan(session)
    ph, pw = padder.padded_shape
    lp, rp = padder.pad_np(zeros, zeros)
    prep = session.get_program("prepare", ph, pw, 0)
    (state,) = session.invoke(prep, lp, rp)
    seg = session.get_program("segment", ph, pw, m)
    session.invoke(seg, state)
    if session.cfg.allow_half_res and min(zeros.shape[1:3]) >= 2:
        half = _downscale_half(zeros)
        warm_segmented_half(session, half)


def warm_segmented_half(session, half_zeros: np.ndarray) -> None:
    _, m = _segment_plan(session)
    half_padder = session.padder_for(half_zeros.shape)
    hh, hw = half_padder.padded_shape
    lp, rp = half_padder.pad_np(half_zeros, half_zeros)
    prep = session.get_program("prepare", hh, hw, 0)
    (state,) = session.invoke(prep, lp, rp)
    seg = session.get_program("segment", hh, hw, m)
    session.invoke(seg, state)


def _run_segmented(session, padder: InputPadder, left: np.ndarray,
                   right: np.ndarray, deadline: float,
                   trace=NULL_TRACE) -> Outcome:
    """Full-resolution anytime loop: prepare, then segments until done or
    out of budget. The first segment always runs."""
    segments, m = _segment_plan(session)
    ph, pw = padder.padded_shape
    lp, rp = padder.pad_np(left, right)

    prep = session.get_program("prepare", ph, pw, 0)
    (state,) = session.invoke(prep, lp, rp, trace=trace)
    seg = session.get_program("segment", ph, pw, m)

    flow = None
    done = 0
    for i in range(segments):
        if flow is not None:  # best-so-far exists; is another chunk safe?
            est = session.estimate(seg.key)
            now = session.clock.now()
            if now >= deadline:
                trace.event("degrade", label=f"reduced_iters:{done}",
                            reason="deadline_expired")
                break
            if est is not None and now + est * SAFETY > deadline:
                trace.event("degrade", label=f"reduced_iters:{done}",
                            reason="predicted_overshoot")
                break
        state, flow, _checksum = session.invoke(seg, state, trace=trace)
        done += m
    missed = session.clock.now() > deadline
    quality = "full" if done == session.cfg.valid_iters \
        else f"reduced_iters:{done}"
    return Outcome(flow, quality, done, missed)


def _downscale_half(img: np.ndarray) -> np.ndarray:
    """(1, H, W, C) -> (1, ceil(H/2), ceil(W/2), C) by 2x2 box filter
    (edge-replicated to even dims first, matching the padder's pad mode)."""
    _, h, w, _ = img.shape
    if h % 2 or w % 2:
        img = np.pad(img, ((0, 0), (0, h % 2), (0, w % 2), (0, 0)),
                     mode="edge")
    return 0.25 * (img[:, 0::2, 0::2] + img[:, 1::2, 0::2]
                   + img[:, 0::2, 1::2] + img[:, 1::2, 1::2])


def _restore_half(flow_half: np.ndarray, orig_h: int,
                  orig_w: int) -> np.ndarray:
    """Half-res flow -> full-res: nearest 2x upsample, crop, values ×2
    (disparity is measured in pixels, and the pixels doubled)."""
    up = flow_half.repeat(2, axis=1).repeat(2, axis=2)
    return 2.0 * up[:, :orig_h, :orig_w, :]


def _half_res_viable(session, padder: InputPadder, deadline: float) -> bool:
    """Drop to half resolution only when the full-res cost is *known* to
    exceed the budget (both the prepare and segment EMAs exist and their
    sum overshoots) AND the half-res programs are already compiled (warm
    the half buckets via ``warmup_segmented``/``warm_segmented``). An
    unknown full-res cost runs at full res — degrading on a guess would
    silently halve quality on every cold bucket — and a cold half bucket
    would trade a blown budget for an XLA compile that dwarfs it."""
    segments, m = _segment_plan(session)
    ph, pw = padder.padded_shape
    prep_key = session.cache_key("prepare", ph, pw, 0)
    seg_key = session.cache_key("segment", ph, pw, m)
    est_prep = session.estimate(prep_key)
    est_seg = session.estimate(seg_key)
    if est_prep is None or est_seg is None:
        return False
    remaining = deadline - session.clock.now()
    if (est_prep + est_seg) * SAFETY <= remaining:
        return False
    # padder.ht/wd are the ORIGINAL image dims; the half route pads
    # ceil(dim/2) onto the session bucket.
    hh = -(-(padder.ht + padder.ht % 2) // 2)
    hw = -(-(padder.wd + padder.wd % 2) // 2)
    half_h, half_w = session.padder_for((hh, hw, 3)).padded_shape
    return (session.has_program("prepare", half_h, half_w, 0)
            and session.has_program("segment", half_h, half_w, m))


def run_with_deadline(session, padder: InputPadder, left: np.ndarray,
                      right: np.ndarray, deadline: float, *,
                      allow_half_res: bool = True,
                      trace=NULL_TRACE) -> Outcome:
    """The degrade policy: full-res segmented scan, or half-res when the
    budget provably cannot fit one full-res segment."""
    if allow_half_res and _half_res_viable(session, padder, deadline):
        trace.event("degrade", label="half_res",
                    reason="budget_below_one_full_res_segment")
        orig_h, orig_w = left.shape[1], left.shape[2]
        left_h = _downscale_half(left)
        right_h = _downscale_half(right)
        half_padder = session.padder_for(left_h.shape)
        out = _run_segmented(session, half_padder, left_h, right_h,
                             deadline, trace=trace)
        flow_half = half_padder.unpad_np(out.flow_padded)
        flow = _restore_half(flow_half, orig_h, orig_w)
        return Outcome(flow, "half_res", out.iters, out.deadline_missed)
    return _run_segmented(session, padder, left, right, deadline,
                          trace=trace)
