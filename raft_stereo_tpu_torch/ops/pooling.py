"""Average pooling as the reference uses it.

- ``avg_pool_w2``: kernel (1, 2), stride (1, 2) over the W axis of
  (..., W, C), dropping an odd trailing column (fmap2's pyramid).
- ``avg_pool_last``: halve the last axis by averaging pairs, dropping an odd
  trailing element (the correlation pyramid).
- ``pool2x``: kernel 3, stride 2, padding 1, ``count_include_pad=True``,
  summed in fp32 (the cross-scale GRU inputs).
- ``pool4x``: kernel 5, stride 4, padding 1, the same way (reference
  ``core/update.py:90-91``; the stereo configurations do not use it).

Under a height shard (``space``), :func:`pool2x` takes the local rows of
an even-height shard: output row ``i`` reads input rows ``2i - 1 .. 2i +
1``, so the shard needs the one row above it (``ops/halo.py``; zeros above
the image, which are the zero padding the pool counts).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_w2(x: torch.Tensor) -> torch.Tensor:
    """Halve the W axis of (..., W, C) by averaging pairs, in fp32, rounded
    once to the input dtype."""
    w = x.shape[-2]
    pairs = x[..., : (w // 2) * 2, :].unflatten(-2, (w // 2, 2))
    return pairs.float().mean(dim=-2).to(x.dtype)


def avg_pool_last(x: torch.Tensor) -> torch.Tensor:
    """Halve the last axis of (..., W) by averaging pairs, in fp32, rounded
    once to the input dtype."""
    w = x.shape[-1]
    pairs = x[..., : (w // 2) * 2].unflatten(-1, (w // 2, 2))
    return pairs.float().mean(dim=-1).to(x.dtype)


def _avg_pool_nhwc(x: torch.Tensor, window: int, stride: int, pad) -> torch.Tensor:
    out = F.avg_pool2d(x.float().permute(0, 3, 1, 2), window, stride=stride, padding=pad,
                       count_include_pad=True)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def pool2x(x: torch.Tensor, space=None) -> torch.Tensor:
    """NHWC 3x3 stride-2 average pool with zero padding counted. With
    ``space`` (a ``ProcessGrid`` with a space axis) ``x`` is this rank's
    rows and so is the result."""
    if space is None:
        return _avg_pool_nhwc(x, 3, 2, 1)
    if x.shape[1] % 2:
        raise ValueError(f"pool2x over a height shard needs an even shard, got {x.shape[1]}")
    from raft_stereo_tpu_torch.ops.halo import exchange_halo
    above = exchange_halo(x, 1, space)[:, :-1]
    return _avg_pool_nhwc(above, 3, 2, (0, 1))


def pool4x(x: torch.Tensor) -> torch.Tensor:
    """NHWC 5x5 stride-4 average pool with zero padding counted."""
    return _avg_pool_nhwc(x, 5, 4, 1)
