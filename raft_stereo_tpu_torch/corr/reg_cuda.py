"""``reg_cuda``: the reg correlation volume with a hand-written CUDA lookup.

Counterpart of the JAX package's ``corr/pallas_reg.py`` in its plain layout.
:func:`build_corr_operands` builds the volume once per frame: a matmul in
the feature-map dtype (bf16 under mixed precision, so the pyramid and the
lookup's traffic are half of fp32), scaled by ``1/sqrt(D)``, then the
width-halving pyramid. Levels are stored unpadded as ``(B*H*W1, W_l)`` rows;
``widths`` are the true level widths, successive floor halving of W2.

:func:`lookup` runs ``csrc/corr_lookup.cu`` on CUDA tensors and
:func:`lookup_plain`, the same arithmetic in torch, on CPU tensors. Both
lerp in fp32 and round once to the volume's dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import torch

from raft_stereo_tpu_torch import kernels
from raft_stereo_tpu_torch.corr.reg import lookup_pyramid
from raft_stereo_tpu_torch.ops.pooling import avg_pool_last

MAX_LEVELS = 8  # csrc/corr_lookup.cu kMaxLevels


def level_widths(w2: int, num_levels: int) -> Tuple[int, ...]:
    """True per-level widths: successive floor halving."""
    ws = [w2]
    for _ in range(num_levels - 1):
        ws.append(ws[-1] // 2)
    return tuple(ws)


@dataclasses.dataclass
class CorrOperands:
    """What the lookup reads: per-level ``(B*H*W1, widths[l])`` rows."""

    levels: List[torch.Tensor]
    widths: Tuple[int, ...]
    radius: int
    b: int
    h: int
    w1: int


def build_corr_operands(fmap1: torch.Tensor, fmap2: torch.Tensor, *,
                        num_levels: int, radius: int,
                        out_dtype: Optional[torch.dtype] = None) -> CorrOperands:
    """Volume and pyramid from (B, H, W, D) feature maps of one dtype.

    The lookup emits the volume's dtype, so ``out_dtype``, when given, must
    be the feature maps' dtype."""
    if out_dtype is not None and out_dtype != fmap1.dtype:
        raise ValueError(f"the lookup emits the volume dtype {fmap1.dtype}, "
                         f"not {out_dtype}")
    b, h, w1, d = fmap1.shape
    w2 = fmap2.shape[2]
    widths = level_widths(w2, num_levels)
    vol = torch.matmul(fmap1, fmap2.transpose(-1, -2)) * (1.0 / d ** 0.5)
    cur = vol.reshape(b * h * w1, w2)
    levels = [cur]
    for _ in range(num_levels - 1):
        cur = avg_pool_last(cur)
        levels.append(cur)
    return CorrOperands(levels, widths, radius, b, h, w1)


def lookup_plain(ops: CorrOperands, coords_x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`lookup`: same taps, same fp32 lerp."""
    coords = coords_x.reshape(-1).float()
    out = lookup_pyramid(ops.levels, coords, ops.radius)
    return out.to(ops.levels[0].dtype).reshape(ops.b, ops.h, ops.w1, -1)


def lookup(ops: CorrOperands, coords_x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W1)`` fp32 x positions -> ``(B, H, W1, L*(2r+1))`` taps.

    CPU tensors take :func:`lookup_plain`; CUDA tensors launch the kernel or
    raise."""
    if coords_x.device.type == "cpu":
        return lookup_plain(ops, coords_x)
    dtype = ops.levels[0].dtype
    nlev = len(ops.levels)
    npix = ops.b * ops.h * ops.w1
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"corr lookup kernel takes bf16 or fp32 volumes, got {dtype}")
    if coords_x.dtype != torch.float32 or coords_x.shape != (ops.b, ops.h, ops.w1):
        raise ValueError(f"coords_x must be fp32 of shape {(ops.b, ops.h, ops.w1)}, "
                         f"got {coords_x.dtype} {tuple(coords_x.shape)}")
    if not 1 <= nlev <= MAX_LEVELS:
        raise ValueError(f"corr lookup kernel takes 1..{MAX_LEVELS} levels, got {nlev}")
    for lvl, w in zip(ops.levels, ops.widths):
        if (lvl.device != coords_x.device or lvl.dtype != dtype
                or lvl.shape != (npix, w) or not lvl.is_contiguous()):
            raise ValueError("corr levels must be contiguous (B*H*W1, width) rows "
                             "of one dtype on the coords' device")
    coords = coords_x.contiguous()
    k = 2 * ops.radius + 1
    out = torch.empty((ops.b, ops.h, ops.w1, nlev * k), dtype=dtype,
                      device=coords.device)
    rows = (ctypes.c_void_p * nlev)(*[lvl.data_ptr() for lvl in ops.levels])
    widths = (ctypes.c_int * nlev)(*ops.widths)
    fn = kernels.entry("corr_lookup")
    kernels.check("corr_lookup", fn(
        coords.data_ptr(), rows, widths, nlev, ops.radius, npix,
        int(dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream(coords.device).cuda_stream))
    kernels.launches["corr_lookup"] += 1
    return out


def corr_fn_from_operands(ops: CorrOperands):
    """The ``corr_fn(coords_x)`` closure over built operands."""

    def corr_fn(coords_x: torch.Tensor) -> torch.Tensor:
        return lookup(ops, coords_x)

    return corr_fn
