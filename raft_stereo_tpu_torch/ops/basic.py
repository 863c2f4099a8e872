"""Convolution and normalization on NHWC tensors.

Layouts follow the JAX package at every public function: activations are
``(B, H, W, C)``. Conv weights keep PyTorch's ``(Cout, Cin, kh, kw)`` layout
so the modules hold reference state-dict tensors as they are. A contiguous
NHWC tensor viewed as NCHW is channels-last in memory, which is the layout
the convolutions run in.

Rounding follows the JAX package (``raft_stereo_tpu/ops/basic.py``):
- ``conv2d`` runs in the input's dtype with one rounding of the fp32
  accumulator, then adds the bias in that dtype; ``out_dtype=float32`` hands
  back the fp32 accumulator instead (the split gate convs sum several);
- ``frozen_batch_norm`` folds the running statistics into one fp32 scale and
  shift, applied in the compute dtype;
- ``instance_norm`` takes fp32 statistics; under bf16 the variance is the
  one-pass ``E[x^2] - E[x]^2``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Pair = Union[int, Tuple[int, int]]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           stride: Pair = 1, padding: Pair = 0,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """2D convolution of NHWC ``x`` with an OIHW weight, symmetric padding.

    bf16 operands are exact in fp32 and their products exact too, so the
    fp32-accumulator form runs the convolution on the upcast operands.
    """
    dtype = x.dtype
    wc = w.to(dtype)
    if out_dtype == torch.float32 and dtype != torch.float32:
        x, wc = x.float(), wc.float()
    out = F.conv2d(x.permute(0, 3, 1, 2), wc, None, stride, padding)
    out = out.permute(0, 2, 3, 1).contiguous()
    if b is not None:
        out = out + b.to(out.dtype)
    return out if out_dtype is None else out.to(out_dtype)


def frozen_batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor, *,
                      eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d in permanent eval mode: affine over the stored statistics."""
    inv = scale.float() * torch.rsqrt(var.float() + eps)
    shift = bias.float() - mean.float() * inv
    return x * inv.to(x.dtype) + shift.to(x.dtype)


def instance_norm(x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d defaults: per (sample, channel) over H, W, biased
    variance, no affine. fp32 statistics; the map stays in its dtype."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    if x.dtype == torch.bfloat16:
        sq = xf.square().mean(dim=(1, 2), keepdim=True)
        var = torch.clamp(sq - mean.square(), min=0.0)
    else:
        var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * inv.to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, *, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (H, W, C // G) per group, affine, in fp32."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h, w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    out = xg.reshape(b, h, w, c) * scale.float() + bias.float()
    return out.to(x.dtype)
