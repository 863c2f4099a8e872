"""``alt_cuda`` (alias ``alt_tpu``): the alt correlation with a hand-written
CUDA kernel, no volume.

Counterpart of the JAX package's ``corr/pallas_alt.py``. The feature maps
keep their dtype (bf16 under mixed precision). :func:`build_alt_operands`
builds the pooled fmap2 pyramid once a segment, in torch: level l is
``(B*H, W2 // 2^l, D)``, each level pooled from the one before it as
``(a + b) * 0.5`` in fmap2's dtype, the rounding the JAX kernel's in-kernel
``_pool_rows`` does (it pools in the kernel on every lookup; this is
O(W*D) once, and the 1.875x f2 pyramid is all the path holds). The JAX
package pads W2 to a multiple of 128 before pooling; unpadded levels give
the same values, since the true-width mask zeroes every entry past level
l's ``W2 // 2^l``.

:func:`lookup` runs ``csrc/corr_alt.cu`` on CUDA tensors: per pixel and
level, the dot products of f1 with the pooled f2 vectors at the 2r+2 whole
positions around ``x / 2^l``, accumulated in fp32, times ``1/sqrt(D)`` in
fp32, zero outside the row, then the lookup's fp32 lerp and one downcast
to the feature maps' dtype. The volume is never rounded. The kernel
computes, for each tile of 64 pixels of a row, the dot block of the tile
with the window of f2 positions its coordinates reach (bf16 on the tensor
cores, fp32 with CUDA-core FMAs). On CPU tensors it
takes :func:`lookup_plain`, which computes the full row product in fp32
from the same pooled rows and gathers from it, a few image rows at a time
(the JAX package's ``_masked_alt_xla``). The two agree up to fp32
association, so within one rounding of the output.

Training: :func:`lookup` is differentiable in f1 and the pooled levels (the
JAX package's ``_alt_lookup`` ``custom_vjp``), its backward autograd
through :func:`lookup_plain` recomputed from the saved operands
(``ops/grad.py``); the gradient reaches both feature maps through the
pooling of :func:`build_alt_operands`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import List, Tuple

import torch

from raft_stereo_tpu_torch import kernels
from raft_stereo_tpu_torch.corr.alt import feature_pyramid
from raft_stereo_tpu_torch.corr.reg import lookup_pyramid
from raft_stereo_tpu_torch.corr.reg_cuda import MAX_LEVELS, level_widths
from raft_stereo_tpu_torch.ops.grad import recompute, refuse_grad

# csrc/corr_alt.cu: D a multiple of 8 bf16 or 4 fp32 values (16 bytes: the
# rows its TMA loads), at most 16 slabs of 64 (bf16) or kMaxD32 (fp32); a
# level's 2r+2 dots are at most kMaxTaps.
_VEC = {torch.bfloat16: 8, torch.float32: 4}
_MAX_D = {torch.bfloat16: 1024, torch.float32: 512}
_MAX_TAPS = 16


@dataclasses.dataclass
class AltOperands:
    """What the alt lookup reads: f1 as ``(B*H*W1, D)`` rows and the pooled
    fmap2 levels as ``(B*H, widths[l], D)``."""

    f1: torch.Tensor
    levels: List[torch.Tensor]
    widths: Tuple[int, ...]
    radius: int
    b: int
    h: int
    w1: int

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.f1.shape[-1])


def build_alt_operands(fmap1: torch.Tensor, fmap2: torch.Tensor, *, num_levels: int,
                       radius: int, out_dtype=None) -> AltOperands:
    """The operands from (B, H, W, D) feature maps of one dtype. The lookup
    emits that dtype, so ``out_dtype``, when given, must be it."""
    if out_dtype is not None and out_dtype != fmap1.dtype:
        raise ValueError(f"the alt lookup emits the feature maps' dtype {fmap1.dtype}, "
                         f"not {out_dtype}")
    if fmap2.dtype != fmap1.dtype:
        raise ValueError(f"feature maps of two dtypes: {fmap1.dtype}, {fmap2.dtype}")
    b, h, w1, d = fmap1.shape
    w2 = fmap2.shape[2]
    levels = [lvl.contiguous() for lvl in
              feature_pyramid(fmap2.reshape(b * h, w2, d), num_levels)]
    return AltOperands(fmap1.reshape(b * h * w1, d).contiguous(), levels,
                       level_widths(w2, num_levels), radius, b, h, w1)


def lookup_plain(ops: AltOperands, coords_x: torch.Tensor, rows: int = 16) -> torch.Tensor:
    """Plain torch version of :func:`lookup`: the fp32 row product of f1 and
    each pooled level, ``rows`` image rows at a time, the lookup's gather
    and lerp, one downcast."""
    d = ops.f1.shape[-1]
    f1 = ops.f1.reshape(ops.b * ops.h, ops.w1, d)
    coords = coords_x.reshape(ops.b * ops.h, ops.w1).float()
    out = []
    for i in range(0, ops.b * ops.h, rows):
        f1c = f1[i:i + rows].float()
        vols = [torch.matmul(f1c, lvl[i:i + rows].float().transpose(-1, -2)) * ops.scale
                for lvl in ops.levels]
        out.append(lookup_pyramid(vols, coords[i:i + rows], ops.radius))
    return torch.cat(out).to(ops.f1.dtype).reshape(ops.b, ops.h, ops.w1, -1)


def lookup(ops: AltOperands, coords_x: torch.Tensor) -> torch.Tensor:
    """:func:`lookup_launch`, differentiable in ``ops.f1`` and
    ``ops.levels`` through :func:`lookup_plain`."""

    def operands(lv):
        return dataclasses.replace(ops, f1=lv[1], levels=list(lv[2:]))

    return recompute(lambda *lv: lookup_launch(operands(lv), lv[0]),
                     lambda *lv: lookup_plain(operands(lv), lv[0]),
                     [coords_x.detach(), ops.f1, *ops.levels], single=True)


def lookup_launch(ops: AltOperands, coords_x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W1)`` fp32 x positions -> ``(B, H, W1, L*(2r+1))`` taps in
    the feature maps' dtype.

    CPU tensors take :func:`lookup_plain`; CUDA tensors launch the kernel or
    raise."""
    refuse_grad("corr_alt", coords_x, ops.f1, ops.levels)
    if coords_x.device.type == "cpu":
        return lookup_plain(ops, coords_x)
    dtype = ops.f1.dtype
    npix, d = ops.f1.shape
    nlev = len(ops.levels)
    if dtype not in _VEC:
        raise TypeError(f"alt kernel takes bf16 or fp32 feature maps, got {dtype}")
    vec = _VEC[dtype]
    if d % vec or d > _MAX_D[dtype]:
        raise ValueError(f"alt kernel takes D a multiple of {vec} up to "
                         f"{_MAX_D[dtype]} for {dtype}, got {d}")
    if coords_x.dtype != torch.float32 or coords_x.shape != (ops.b, ops.h, ops.w1):
        raise ValueError(f"coords_x must be fp32 of shape {(ops.b, ops.h, ops.w1)}, "
                         f"got {coords_x.dtype} {tuple(coords_x.shape)}")
    if not 1 <= nlev <= MAX_LEVELS or 2 * ops.radius + 2 > _MAX_TAPS:
        raise ValueError(f"alt kernel takes 1..{MAX_LEVELS} levels and a radius up to "
                         f"{_MAX_TAPS // 2 - 1}, got {nlev} and {ops.radius}")
    for t, shape in [(ops.f1, (npix, d))] + [
            (lvl, (ops.b * ops.h, w, d)) for lvl, w in zip(ops.levels, ops.widths)]:
        if (t.device != coords_x.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("alt operands must be contiguous, 16-byte aligned rows of "
                             "one dtype on the coords' device")
    coords = coords_x.contiguous()
    k = 2 * ops.radius + 1
    out = torch.empty((ops.b, ops.h, ops.w1, nlev * k), dtype=dtype, device=coords.device)
    rows = (ctypes.c_void_p * nlev)(*[lvl.data_ptr() for lvl in ops.levels])
    widths = (ctypes.c_int * nlev)(*ops.widths)
    fn = kernels.entry("corr_alt")
    kernels.check("corr_alt", fn(
        coords.data_ptr(), ops.f1.data_ptr(), rows, widths, nlev, ops.radius, npix, ops.w1,
        d, ops.scale, int(dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream(coords.device).cuda_stream))
    kernels.count_launch("corr_alt")
    return out


def make_alt_cuda_corr_fn(fmap1: torch.Tensor, fmap2: torch.Tensor, *, num_levels: int,
                          radius: int, out_dtype=None):
    ops = build_alt_operands(fmap1, fmap2, num_levels=num_levels, radius=radius,
                             out_dtype=out_dtype)

    def corr_fn(coords_x: torch.Tensor) -> torch.Tensor:
        return lookup(ops, coords_x)

    return corr_fn
