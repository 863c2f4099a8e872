"""``reg`` correlation: the all-pairs 1D volume, its pyramid and a plain
torch lookup, in fp32 (reference ``CorrBlock1D``, ``core/corr.py:110-156``).

Only levels ``0 .. num_levels - 1`` are built: the reference builds one more
and never reads it.
"""

from __future__ import annotations

import math
from typing import List

import torch

from raft_stereo_tpu_torch.ops.pooling import avg_pool_last


def build_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """(B, H, W1, W2) fp32 correlation along rows, over sqrt(D)."""
    d = fmap1.shape[-1]
    vol = torch.matmul(fmap1.float(), fmap2.float().transpose(-1, -2))
    return vol / math.sqrt(d)


def build_pyramid(volume: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Width-halving pyramid: level i is (B, H, W1, W2 // 2^i)."""
    pyramid = [volume]
    for _ in range(num_levels - 1):
        pyramid.append(avg_pool_last(pyramid[-1]))
    return pyramid


def lookup_pyramid(pyramid: List[torch.Tensor], coords_x: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """``2r+1`` lerped taps around ``coords_x / 2^i`` per level, zero outside
    the row. Returns (B, H, W1, levels * (2r+1)), level-major."""
    out = []
    offsets = torch.arange(-radius, radius + 2, device=coords_x.device)
    for i, vol in enumerate(pyramid):
        w2 = vol.shape[-1]
        cl = coords_x.float() / (2 ** i)
        i0 = torch.floor(cl)
        frac = (cl - i0)[..., None]
        i0 = torch.clamp(i0, -radius - 2, w2 + radius + 1).long()
        pos = i0[..., None] + offsets
        valid = (pos >= 0) & (pos < w2)
        g = torch.gather(vol.float(), -1, pos.clamp(0, w2 - 1))
        g = torch.where(valid, g, torch.zeros((), device=g.device))
        out.append(g[..., :-1] * (1.0 - frac) + g[..., 1:] * frac)
    return torch.cat(out, dim=-1)


def make_reg_corr_fn(fmap1: torch.Tensor, fmap2: torch.Tensor, *,
                     num_levels: int, radius: int, out_dtype=None):
    pyramid = build_pyramid(build_volume(fmap1, fmap2), num_levels)

    def corr_fn(coords_x: torch.Tensor) -> torch.Tensor:
        out = lookup_pyramid(pyramid, coords_x, radius)
        return out if out_dtype is None else out.to(out_dtype)

    return corr_fn
