"""Learned convex-combination upsampling (reference ``core/raft_stereo.py:55-67``).

The mask has ``factor**2 * 9`` channels viewed as ``(9, factor, factor)``
with the 3x3 neighbourhood index outermost, neighbourhood taps row-major.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _patches3x3(x: torch.Tensor, rows_padded: bool = False) -> torch.Tensor:
    """3x3 zero-padded patches of (B, H, W, C) -> (B, H, W, 9, C); with
    ``rows_padded`` ``x`` already holds one extra row on each side
    (B, H + 2, W, C) and only the width is padded."""
    b, h, w, c = x.shape
    if rows_padded:
        h -= 2
    xp = F.pad(x, (0, 0, 1, 1, 0 if rows_padded else 1, 0 if rows_padded else 1))
    return torch.stack([xp[:, dy:dy + h, dx:dx + w, :]
                        for dy in range(3) for dx in range(3)], dim=3)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int,
                    space=None) -> torch.Tensor:
    """Upsample (B, H, W, D) flow to (B, factor*H, factor*W, D) in fp32.

    mask: (B, H, W, factor**2 * 9) logits from the mask head. With
    ``space`` (a height shard) both are this rank's rows, and so is the
    result: the patches take one row from each neighbour (``ops/halo.py``;
    zeros beyond the image, its zero padding).
    """
    b, h, w, d = flow.shape
    mask = torch.softmax(mask.float().reshape(b, h, w, 9, factor, factor), dim=3)
    if space is not None:
        from raft_stereo_tpu_torch.ops.halo import exchange_halo
        patches = _patches3x3(exchange_halo(flow.float() * factor, 1, space), True)
    else:
        patches = _patches3x3(flow.float() * factor)
    up = torch.einsum("bhwkyx,bhwkd->bhywxd", mask, patches)
    return up.reshape(b, h * factor, w * factor, d).to(flow.dtype)
