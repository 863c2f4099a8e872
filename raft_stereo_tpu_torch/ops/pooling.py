"""Average pooling as the reference uses it.

- ``avg_pool_last``: halve the last axis by averaging pairs, dropping an odd
  trailing element (the correlation pyramid).
- ``pool2x``: kernel 3, stride 2, padding 1, ``count_include_pad=True``,
  summed in fp32 (the cross-scale GRU inputs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_last(x: torch.Tensor) -> torch.Tensor:
    """Halve the last axis of (..., W) by averaging pairs, in fp32, rounded
    once to the input dtype."""
    w = x.shape[-1]
    pairs = x[..., : (w // 2) * 2].unflatten(-1, (w // 2, 2))
    return pairs.float().mean(dim=-1).to(x.dtype)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC 3x3 stride-2 average pool with zero padding counted."""
    out = F.avg_pool2d(x.float().permute(0, 3, 1, 2), 3, stride=2, padding=1,
                       count_include_pad=True)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()
