"""Coordinate grids: ``(B, H, W, 2)`` fields with ``[..., 0] = x`` and
``[..., 1] = y``. The network regresses negative disparity in x."""

from __future__ import annotations

import torch

from raft_stereo_tpu_torch.ops.resize import interp_align_corners


def coords_grid(batch: int, ht: int, wd: int, *, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 2) pixel-coordinate grid, x first."""
    y, x = torch.meshgrid(torch.arange(ht, device=device, dtype=dtype),
                          torch.arange(wd, device=device, dtype=dtype),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)[None].expand(batch, ht, wd, 2)


def upflow(flow: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Aligned-corners bilinear upsample of a (B, H, W, C) flow by
    ``factor``, scaled by it (reference ``core/utils/utils.py:82-84``; used
    only where no learned upsampling mask exists)."""
    _, h, w, _ = flow.shape
    return factor * interp_align_corners(flow, (factor * h, factor * w))
