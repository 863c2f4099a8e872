"""Aligned-corners bilinear resize as two banded-matrix contractions.

The JAX package (``ops/resize.py``) resizes with an (out, in) lerp matrix per
axis, two nonzeros per row, built in fp32 and rounded to the input dtype,
then contracted with fp32 accumulation and rounded once per axis.
``F.interpolate(align_corners=True)`` computes ``a + (b - a) * w`` instead
and is not value-equal in bf16, so the matrix form is kept.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch


def _lerp_index(in_size: int, out_size: int, device: torch.device):
    """Per output position: the lower source index, the upper one (the same
    at the last position) and the fp32 weight of the upper one."""
    if out_size == 1:
        src = torch.zeros(1, dtype=torch.float32, device=device)
    else:
        scale = (in_size - 1) / (out_size - 1)
        src = torch.arange(out_size, dtype=torch.float32, device=device) * scale
    lo = torch.clamp(torch.floor(src), 0, in_size - 1).long()
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    return lo, hi, src - lo.float()


@functools.lru_cache(maxsize=64)
def _lerp_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(out, in) aligned-corners lerp matrix, rounded to ``dtype`` and held
    in fp32. Cached: it depends only on its arguments, the refinement loop
    asks for the same four every iteration, and building one takes some
    forty small launches on a GPU. Callers only read it."""
    lo, hi, wt = _lerp_index(in_size, out_size, device)
    m = torch.zeros(out_size, in_size, dtype=torch.float32, device=device)
    rows = torch.arange(out_size, device=device)
    m.index_put_((rows, lo), 1 - wt, accumulate=True)
    m.index_put_((rows, hi), wt, accumulate=True)
    return m.to(dtype).float()


@functools.lru_cache(maxsize=64)
def lerp_taps(in_size: int, out_size: int, dtype: torch.dtype,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two nonzeros of each row of :func:`_lerp_matrix`: ``(idx, wt)``,
    (out, 2) int32 source indices and (out, 2) fp32 weights, read from the
    matrix itself, so each weight is the matrix's already-rounded entry
    (where both taps are one index, the last row, the summed entry and a
    zero). ``sum_k wt[o, k] * x[idx[o, k]]`` is row ``o`` of the matrix
    product. Cached like the matrix; the gru16+32 kernel upsamples with
    them."""
    m = _lerp_matrix(in_size, out_size, dtype, device)
    lo, hi, _ = _lerp_index(in_size, out_size, device)
    rows = torch.arange(out_size, device=device)
    w_hi = torch.where(hi != lo, m[rows, hi], torch.zeros((), device=device))
    idx = torch.stack([lo, hi], dim=-1).to(torch.int32).contiguous()
    return idx, torch.stack([m[rows, lo], w_hi], dim=-1).contiguous()


def interp_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) to (B, size[0], size[1], C),
    align_corners=True."""
    b, h, w, c = x.shape
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    out = x
    if oh != h:
        m = _lerp_matrix(h, oh, x.dtype, x.device)
        out = torch.einsum("Oh,bhwc->bOwc", m, out.float()).to(x.dtype)
    if ow != w:
        m = _lerp_matrix(w, ow, x.dtype, x.device)
        out = torch.einsum("Pw,bOwc->bOPc", m, out.float()).to(x.dtype)
    return out.contiguous()
