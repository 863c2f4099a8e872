"""Layers on NHWC tensors that hold reference-layout parameters.

Each module subclasses the ``torch.nn`` module the reference uses, so its
parameter and buffer names and shapes are the reference state dict's, and
overrides ``forward`` to take ``(B, H, W, C)`` tensors through the port's
ops with the JAX package's rounding (``ops/basic.py``). Initialization
follows the JAX package: Kaiming-normal (fan_out, relu) conv weights and
uniform ``1/sqrt(fan_in)`` biases, drawn from the caller's generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from raft_stereo_tpu_torch.ops.basic import (
    conv2d, frozen_batch_norm, group_norm, instance_norm)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` applied to NHWC tensors in the input's dtype."""

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, stride=self.stride,
                      padding=self.padding, out_dtype=out_dtype)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalizes with its running statistics (the
    reference freezes BN)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return frozen_batch_norm(x, self.weight, self.bias, self.running_mean,
                                 self.running_var, eps=self.eps)


class InstanceNorm2d(nn.InstanceNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, eps=self.eps)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, eps=self.eps)


def make_norm(norm_fn: str, c: int, num_groups: int) -> nn.Module:
    if norm_fn == "batch":
        return FrozenBatchNorm2d(c)
    if norm_fn == "group":
        return GroupNorm(num_groups, c)
    if norm_fn == "instance":
        return InstanceNorm2d(c)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm_fn {norm_fn!r}")


class ResidualBlock(nn.Module):
    """Reference ``ResidualBlock`` (``core/extractor.py:6-60``). The shortcut
    norm is registered as ``norm3`` and as ``downsample.1``, as there."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        groups = planes // 8
        self.norm1 = make_norm(norm_fn, planes, groups)
        self.norm2 = make_norm(norm_fn, planes, groups)
        if stride == 1 and in_planes == planes:
            self.downsample = None
        else:
            self.norm3 = make_norm(norm_fn, planes, groups)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BottleneckBlock(nn.Module):
    """Reference ``BottleneckBlock`` (``core/extractor.py:64-120``): 1x1 down
    to ``planes // 4``, a 3x3 at ``stride``, 1x1 back up, each normed and
    ReLU'd; a strided block's shortcut norm is registered as ``norm4`` and as
    ``downsample.1``, as there. Unused by the stereo model, in either
    package (the JAX package's ``apply_bottleneck_block``)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes // 4, 1)
        self.conv2 = Conv2d(planes // 4, planes // 4, 3, padding=1, stride=stride)
        self.conv3 = Conv2d(planes // 4, planes, 1)
        groups = planes // 8
        self.norm1 = make_norm(norm_fn, planes // 4, groups)
        self.norm2 = make_norm(norm_fn, planes // 4, groups)
        self.norm3 = make_norm(norm_fn, planes, groups)
        if stride == 1:
            self.downsample = None
        else:
            self.norm4 = make_norm(norm_fn, planes, groups)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride), self.norm4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = torch.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every conv with the JAX package's initialization and every norm
    with scale 1, shift 0, mean 0, var 1, drawing from ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            cout, cin, kh, kw = m.weight.shape
            std = math.sqrt(2.0 / (cout * kh * kw))
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(cin * kh * kw)
                    m.bias.copy_((torch.rand(m.bias.shape, generator=generator) * 2 - 1)
                                 * bound)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
