"""Feature and context encoders (reference ``core/extractor.py``), NHWC.

- :class:`BasicEncoder`: the feature net. A 7x7 stem, three stages of two
  residual blocks at 64/96/128 channels, and a 1x1 conv to ``output_dim``.
- :class:`MultiBasicEncoder`: the context net. The same trunk plus
  ``layer4``/``layer5`` at stride 2, with per-scale heads. As in the
  reference, ``outputs08`` (finest) emits ``dim[2]`` channels and
  ``outputs32`` (coarsest) ``dim[0]``.

Routing follows the JAX package's ``apply_basic_encoder`` and
``apply_multi_basic_encoder`` at their defaults. Where the gates of
``ops/encoder.py`` hold (bf16, one sample, stride-1 stem, identity
shortcuts), the stem and layer1 run as the fused chain (frozen BatchNorm
folded into the convs for the context net, streamed instance-norm statistics
for the feature net), and the stride-1 second block of layer2 and layer3 and
the finest heads' residual block and 3x3 conv run as streamed passes. The
stride-2 entry blocks, ``layer4``/``layer5`` and the coarser heads stay plain
convolutions with torch norms, as does everything in fp32, at B > 1, or with
``RAFT_FUSED_ENCODERS=0`` (``RAFT_STREAM_TAIL=0`` keeps only the trunk
fused). The fused chains are differentiable (``ops/encoder.py``), so
training at B=1 in bf16 runs them too, as the JAX package's does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from raft_stereo_tpu_torch.models.layers import Conv2d, ResidualBlock, make_norm
from raft_stereo_tpu_torch.ops import encoder as enc


def _trunk_strides(downsample: int) -> Tuple[int, int, int]:
    return (1 + (downsample > 2), 1 + (downsample > 1), 1 + (downsample > 0))


def _stage(in_planes: int, dim: int, norm_fn: str, stride: int) -> nn.Sequential:
    return nn.Sequential(ResidualBlock(in_planes, dim, norm_fn, stride=stride),
                         ResidualBlock(dim, dim, norm_fn, stride=1))


def _apply_stage(stage: nn.Sequential, x: torch.Tensor, norm_fn: str) -> torch.Tensor:
    """The entry block plain; the stride-1 second block streamed when it can be."""
    return _maybe_stream_block(stage[1], stage[0](x), norm_fn)


def _maybe_stream_block(block: ResidualBlock, x: torch.Tensor, norm_fn: str) -> torch.Tensor:
    if enc.resblock_streamable(block, x, norm_fn):
        return enc.stream_resblock(block, x, norm_fn)
    return block(x)


class _Trunk(nn.Module):
    """Stem and layer1..layer3, shared by both encoders."""

    def __init__(self, norm_fn: str, downsample: int):
        super().__init__()
        self.norm_fn = norm_fn
        s_stem, s2, s3 = _trunk_strides(downsample)
        self.conv1 = Conv2d(3, 64, 7, stride=s_stem, padding=3)
        # The stem GroupNorm uses 8 groups, unlike the blocks (planes // 8).
        self.norm1 = make_norm(norm_fn, 64, 8)
        self.layer1 = _stage(64, 64, norm_fn, 1)
        self.layer2 = _stage(64, 96, norm_fn, s2)
        self.layer3 = _stage(96, 128, norm_fn, s3)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        s_stem = self.conv1.stride[0]
        if enc.stem_layer1_is_fusable(self, x, self.norm_fn, s_stem):
            y = enc.fused_stem_layer1(self, x)
        elif enc.in_stem_layer1_is_fusable(self, x, self.norm_fn, s_stem):
            y = enc.fused_in_stem_layer1(self, x)
        else:
            y = self.layer1(torch.relu(self.norm1(self.conv1(x))))
        y = _apply_stage(self.layer2, y, self.norm_fn)
        return _apply_stage(self.layer3, y, self.norm_fn)


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

    def _head08(self, head: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """A finest-scale head: its residual block and 3x3 conv streamed
        when they can be."""
        res, conv = head
        x = _maybe_stream_block(res, x, self.norm_fn)
        if enc.head_conv_streamable(conv, x):
            return enc.stream_head_conv(conv, x)
        return conv(x)

    def forward(self, x: torch.Tensor, dual_inp: bool = False, num_layers: int = 3):
        """Per-scale head lists, finest first; with ``dual_inp`` also the
        full-batch trunk features (the shared-backbone mode)."""
        x = self.trunk(x)
        if dual_inp:
            v = x
            x = x[: x.shape[0] // 2]
        outputs = [[self._head08(head, x) for head in self.outputs08]]
        if num_layers >= 2:
            y = self.layer4(x)
            outputs.append([head(y) for head in self.outputs16])
        if num_layers == 3:
            z = self.layer5(y)
            outputs.append([head(z) for head in self.outputs32])
        return (*outputs, v) if dual_inp else tuple(outputs)
