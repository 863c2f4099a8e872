"""The control: the reference computed one precision below the port's.

The configurations state bf16 (``mixed_precision``), so the control is the
reference with every convolution and the correlation's matrix product fed
float8 (e4m3) operands, each tensor scaled by its own absolute maximum as
fp8 inference on the H100 does, accumulated in float32, and every
convolution's output rounded to bf16: the step to the card's fp8 tensor
cores that would tempt a later change. The correctness check has to find
its answers wrong.
"""

from __future__ import annotations

import torch
import torch.nn as nn

E4M3_MAX = 448.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with a per-tensor scale, back in its dtype."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


def _fp8_input(module, args):
    return (to_fp8(args[0]),)


def _bf16_output(module, args, out):
    return out.to(torch.bfloat16).to(out.dtype)


@torch.no_grad()
def lower_precision(model: nn.Module) -> nn.Module:
    """Turn a float32 reference model into the control, in place."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.copy_(to_fp8(m.weight))
            m.register_forward_pre_hook(_fp8_input)
            m.register_forward_hook(_bf16_output)
    model.corr_cast = to_fp8
    return model
