"""``alt`` correlation: no volume; each lookup samples pooled fmap2 rows.

Counterpart of the JAX package's ``corr/alt.py`` (reference
``PytorchAlternateCorrBlock1D``, ``core/corr.py:64-107``), in fp32. Per
level l, fmap2 is pooled along W by pairs (floor halving) once per frame;
a lookup takes, for each pixel, the pooled fmap2 vectors at the 2r+2 whole
positions around ``x / 2^l`` (zero outside the row), dots them with the
pixel's fmap1 vector over ``sqrt(D)`` and lerps the 2r+1 outputs. Sampling
then dotting equals dotting then sampling (the dot is linear), so this is
``reg`` up to floating-point association; it holds no W^2 volume, and works
through the image rows in chunks, so its memory stays linear in W.
"""

from __future__ import annotations

import math
from typing import List

import torch


def pool_rows(f2: torch.Tensor) -> torch.Tensor:
    """(..., W, D) -> (..., W // 2, D): pairs along W averaged as
    ``(a + b) * 0.5`` in the input's dtype (an odd last entry is dropped)."""
    half = f2.shape[-2] // 2
    return (f2[..., 0:2 * half:2, :] + f2[..., 1:2 * half:2, :]) * 0.5


def feature_pyramid(fmap2: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Level l of fmap2 (..., W, D) is (..., W // 2^l, D), each pooled from
    the one before it in fmap2's dtype."""
    levels = [fmap2]
    for _ in range(num_levels - 1):
        levels.append(pool_rows(levels[-1]))
    return levels


def _lookup_rows(f1: torch.Tensor, coords_x: torch.Tensor, pyramid: List[torch.Tensor],
                 radius: int, scale: float) -> torch.Tensor:
    """f1 (..., W1, D) fp32, coords_x (..., W1), pyramid[l] (..., W_l, D)
    fp32 -> (..., W1, L * (2r+1)) fp32."""
    offsets = torch.arange(-radius, radius + 2, device=coords_x.device)
    out = []
    for i, f2 in enumerate(pyramid):
        w2, d = f2.shape[-2:]
        cl = coords_x.float() / (2 ** i)
        i0 = torch.floor(cl)
        frac = (cl - i0)[..., None]
        i0 = torch.clamp(i0, -radius - 2, w2 + radius + 1).long()
        pos = i0[..., None] + offsets                      # (..., W1, 2r+2)
        valid = (pos >= 0) & (pos < w2)
        idx = pos.clamp(0, max(w2 - 1, 0)).flatten(-2)     # (..., W1 * (2r+2))
        rows = torch.gather(f2, -2, idx[..., None].expand(*idx.shape, d))
        dots = (rows.unflatten(-2, pos.shape[-2:]) * f1[..., None, :]).sum(-1) * scale
        g = torch.where(valid, dots, torch.zeros((), device=dots.device))
        out.append(g[..., :-1] * (1.0 - frac) + g[..., 1:] * frac)
    return torch.cat(out, dim=-1)


def make_alt_corr_fn(fmap1: torch.Tensor, fmap2: torch.Tensor, *, num_levels: int,
                     radius: int, out_dtype=None, h_chunk: int = 8):
    """``corr_fn(coords_x)`` over (B, H, W, D) feature maps, in fp32; the
    lookup runs ``h_chunk`` image rows at a time."""
    f1 = fmap1.float()
    pyramid = feature_pyramid(fmap2.float(), num_levels)
    scale = 1.0 / math.sqrt(fmap1.shape[-1])

    def corr_fn(coords_x: torch.Tensor) -> torch.Tensor:
        h = coords_x.shape[1]
        out = torch.cat([
            _lookup_rows(f1[:, i:i + h_chunk], coords_x[:, i:i + h_chunk],
                         [f2[:, i:i + h_chunk] for f2 in pyramid], radius, scale)
            for i in range(0, h, h_chunk)], dim=1)
        return out if out_dtype is None else out.to(out_dtype)

    return corr_fn
