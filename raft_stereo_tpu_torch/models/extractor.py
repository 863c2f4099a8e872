"""Feature and context encoders (reference ``core/extractor.py``), NHWC.

- :class:`BasicEncoder`: the feature net. A 7x7 stem, three stages of two
  residual blocks at 64/96/128 channels, and a 1x1 conv to ``output_dim``.
- :class:`MultiBasicEncoder`: the context net. The same trunk plus
  ``layer4``/``layer5`` at stride 2, with per-scale heads. As in the
  reference, ``outputs08`` (finest) emits ``dim[2]`` channels and
  ``outputs32`` (coarsest) ``dim[0]``.

These are the JAX package's unfused encoders (``fused=False``): plain
convolutions, which the JAX package leaves to XLA on this slice's path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from raft_stereo_tpu_torch.models.layers import Conv2d, ResidualBlock, make_norm


def _trunk_strides(downsample: int) -> Tuple[int, int, int]:
    return (1 + (downsample > 2), 1 + (downsample > 1), 1 + (downsample > 0))


def _stage(in_planes: int, dim: int, norm_fn: str, stride: int) -> nn.Sequential:
    return nn.Sequential(ResidualBlock(in_planes, dim, norm_fn, stride=stride),
                         ResidualBlock(dim, dim, norm_fn, stride=1))


class _Trunk(nn.Module):
    """Stem and layer1..layer3, shared by both encoders."""

    def __init__(self, norm_fn: str, downsample: int):
        super().__init__()
        s_stem, s2, s3 = _trunk_strides(downsample)
        self.conv1 = Conv2d(3, 64, 7, stride=s_stem, padding=3)
        # The stem GroupNorm uses 8 groups, unlike the blocks (planes // 8).
        self.norm1 = make_norm(norm_fn, 64, 8)
        self.layer1 = _stage(64, 64, norm_fn, 1)
        self.layer2 = _stage(64, 96, norm_fn, s2)
        self.layer3 = _stage(96, 128, norm_fn, s3)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(_Trunk):
    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 downsample: int = 3):
        super().__init__(norm_fn, downsample)
        self.conv2 = Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.trunk(x))


class MultiBasicEncoder(_Trunk):
    def __init__(self, output_dim: Sequence[Sequence[int]], norm_fn: str = "batch",
                 downsample: int = 3):
        super().__init__(norm_fn, downsample)
        self.layer4 = _stage(128, 128, norm_fn, 2)
        self.layer5 = _stage(128, 128, norm_fn, 2)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, stride=1),
                          Conv2d(128, dim[2], 3, padding=1)) for dim in output_dim)
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, stride=1),
                          Conv2d(128, dim[1], 3, padding=1)) for dim in output_dim)
        self.outputs32 = nn.ModuleList(
            Conv2d(128, dim[0], 3, padding=1) for dim in output_dim)

    def forward(self, x: torch.Tensor, dual_inp: bool = False, num_layers: int = 3):
        """Per-scale head lists, finest first; with ``dual_inp`` also the
        full-batch trunk features (the shared-backbone mode)."""
        x = self.trunk(x)
        if dual_inp:
            v = x
            x = x[: x.shape[0] // 2]
        outputs = [[head(x) for head in self.outputs08]]
        if num_layers >= 2:
            y = self.layer4(x)
            outputs.append([head(y) for head in self.outputs16])
        if num_layers == 3:
            z = self.layer5(y)
            outputs.append([head(z) for head in self.outputs32])
        return (*outputs, v) if dual_inp else tuple(outputs)
