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


@functools.lru_cache(maxsize=64)
def _lerp_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(out, in) aligned-corners lerp matrix, rounded to ``dtype`` and held
    in fp32. Cached: it depends only on its arguments, the refinement loop
    asks for the same four every iteration, and building one takes some
    forty small launches on a GPU. Callers only read it."""
    if out_size == 1:
        src = torch.zeros(1, dtype=torch.float32, device=device)
    else:
        scale = (in_size - 1) / (out_size - 1)
        src = torch.arange(out_size, dtype=torch.float32, device=device) * scale
    lo = torch.clamp(torch.floor(src), 0, in_size - 1).long()
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    wt = src - lo.float()
    m = torch.zeros(out_size, in_size, dtype=torch.float32, device=device)
    rows = torch.arange(out_size, device=device)
    m.index_put_((rows, lo), 1 - wt, accumulate=True)
    m.index_put_((rows, hi), wt, accumulate=True)
    return m.to(dtype).float()


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
