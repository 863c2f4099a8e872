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

Under ``RAFT_CORR_PACK8=1`` a bf16 pyramid is also quantized to int8 when
the operands are built (the JAX package's ``level_scale8`` and
``quantize_pack_rows8``): per sample and level, ``scale = max(amax,
1e-30) / 127`` over that sample's rows and ``q = clip(round(v / scale),
-127, 127)``, in fp32. The lookup and the resident kernel then read the
int8 levels and dequantize each tap as ``q * scale`` in fp32, after the
true-width mask, before the lerp; the taps are still emitted in bf16. The
JAX package's combined four-per-lane container is TPU layout: the int8
levels here are plain ``(B*H*W1, W_l)`` rows and the scales a ``(B, L)``
tensor.

The same module holds the feature quantization of ``RAFT_LANE_PACK8``
(the JAX package's ``feature_scale8``, ``quantize_pack_feature8`` and
``unpack_feature8``): a ``(B, ...)`` tensor becomes a :class:`Lane8`, its
int8 values in the tensor's own shape and one fp32 scale per sample,
``max(amax, 1e-30) / 127`` over every non-batch element. The JAX package's
width-group fp32 container (four int8 lanes in one 32-bit lane, the width
padded to a multiple of 4) is TPU layout and is not carried over.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch

from raft_stereo_tpu_torch import kernels
from raft_stereo_tpu_torch.config import corr_pack8_on
from raft_stereo_tpu_torch.corr.reg import lookup_pyramid
from raft_stereo_tpu_torch.ops.grad import refuse_grad
from raft_stereo_tpu_torch.ops.pooling import avg_pool_last

MAX_LEVELS = 8  # csrc/corr_taps.cuh kMaxLevels
MAX_RADIUS = 13  # csrc/corr_lookup.cu: the widest window of fp32 levels


def level_widths(w2: int, num_levels: int) -> Tuple[int, ...]:
    """True per-level widths: successive floor halving."""
    ws = [w2]
    for _ in range(num_levels - 1):
        ws.append(ws[-1] // 2)
    return tuple(ws)


@dataclasses.dataclass
class CorrOperands:
    """What the lookup reads: per-level ``(B*H*W1, widths[l])`` rows; under
    pack8 the int8 levels of the same shape and their ``(B, L)`` fp32
    scales too, which the kernels then read instead."""

    levels: List[torch.Tensor]
    widths: Tuple[int, ...]
    radius: int
    b: int
    h: int
    w1: int
    levels8: Optional[List[torch.Tensor]] = None
    scales: Optional[torch.Tensor] = None
    # What kernel_levels built for the kernels, with the tensors it was
    # built from; rebuilt when the device or any of those tensors changes.
    _kernel_args: Optional["_KernelArgs"] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def pack8(self) -> bool:
        return self.levels8 is not None


class _KernelArgs(NamedTuple):
    device: torch.device
    rows: Tuple[torch.Tensor, ...]
    scales: Optional[torch.Tensor]
    args: tuple  # kernel_levels' result


def quantize_levels8(levels: List[torch.Tensor], b: int
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Per-sample symmetric int8 levels and their ``(B, L)`` fp32 scales.
    Per sample, so a sample's quantization does not depend on its
    batchmates."""
    qs, scales = [], []
    for lvl in levels:
        rows = lvl.float().reshape(b, -1)
        scale = rows.abs().amax(dim=1).clamp_min(1e-30) / 127.0
        q = torch.clamp(torch.round(rows / scale[:, None]), -127.0, 127.0)
        qs.append(q.to(torch.int8).reshape(lvl.shape))
        scales.append(scale)
    return qs, torch.stack(scales, dim=1).contiguous()


class Lane8(NamedTuple):
    """An int8 lane container: ``q`` in the source tensor's shape, ``scale``
    ``(B,)`` fp32, so that the value is ``q * scale[b]``."""

    q: torch.Tensor
    scale: torch.Tensor


def feature_scale8(x: torch.Tensor) -> torch.Tensor:
    """Per-sample dequant scale of a ``(B, ...)`` tensor, ``(B,)`` fp32:
    ``max(amax|v|, 1e-30) / 127`` over every non-batch element, so a
    sample's grid does not depend on its batchmates."""
    lo, hi = torch.aminmax(x.reshape(x.shape[0], -1), dim=1)
    amax = torch.maximum(-lo.float(), hi.float())  # max |v|, without an fp32 copy of x
    return amax.clamp_min(1e-30) / 127.0


def _per_sample(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape((-1,) + (1,) * (ndim - 1))


def quantize_feature8(x: torch.Tensor) -> Lane8:
    """``q = clip(round_half_even(v / scale), -127, 127)`` in fp32 with the
    scale of :func:`feature_scale8`. Zeros stay exact zeros. One fp32 copy
    of ``x`` at a time (the operations work in place on it)."""
    scale = feature_scale8(x)
    q = x.to(torch.float32, copy=True).div_(_per_sample(scale, x.ndim))
    q = q.round_().clamp_(-127.0, 127.0)
    return Lane8(q.to(torch.int8).contiguous(), scale.contiguous())


def dequantize_feature8(lane: Lane8, dtype: torch.dtype) -> torch.Tensor:
    """The container's values ``q * scale`` in fp32 (in fp32 they are what
    the kernels add), cast once to ``dtype``."""
    return lane.q.to(torch.float32).mul_(_per_sample(lane.scale, lane.q.ndim)).to(dtype)


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
    ops = CorrOperands(levels, widths, radius, b, h, w1)
    if vol.dtype == torch.bfloat16 and corr_pack8_on():
        ops.levels8, ops.scales = quantize_levels8(levels, b)
    return ops


def lookup_plain(ops: CorrOperands, coords_x: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain torch version of :func:`lookup`: same taps (dequantized under
    pack8), same fp32 lerp. ``out_dtype`` (default: the volume's dtype, as
    the kernel) is where the fp32 taps are rounded to."""
    coords = coords_x.reshape(-1).float()
    levels = ops.levels
    if ops.pack8:
        per_row = ops.h * ops.w1
        levels = [q.float() * ops.scales[:, i].repeat_interleave(per_row)[:, None]
                  for i, q in enumerate(ops.levels8)]
    out = lookup_pyramid(levels, coords, ops.radius)
    dtype = ops.levels[0].dtype if out_dtype is None else out_dtype
    return out.to(dtype).reshape(ops.b, ops.h, ops.w1, -1)


def kernel_levels(ops: CorrOperands, device: torch.device):
    """The level rows, their widths, the mode (0 fp32, 1 bf16, 2 int8 with
    scales) and the scales' pointer, as the kernels take them (ctypes);
    raises on operands they do not take. Checked and built once for the
    operands' tensors and ``device``, cached on ``ops``."""
    rows, scales = (ops.levels8, ops.scales) if ops.pack8 else (ops.levels, None)
    cached = ops._kernel_args
    if (cached is not None and cached.device == device and cached.scales is scales
            and len(cached.rows) == len(rows)
            and all(a is b for a, b in zip(cached.rows, rows))):
        return cached.args
    dtype = ops.levels[0].dtype
    nlev = len(ops.levels)
    npix = ops.b * ops.h * ops.w1
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"corr kernels take bf16 or fp32 volumes, got {dtype}")
    if not 1 <= nlev <= MAX_LEVELS:
        raise ValueError(f"corr kernels take 1..{MAX_LEVELS} levels, got {nlev}")
    want = torch.int8 if ops.pack8 else dtype
    if ops.pack8 and (scales.device != device or scales.dtype != torch.float32
                      or scales.shape != (ops.b, nlev) or not scales.is_contiguous()):
        raise ValueError(f"pack8 scales must be contiguous fp32 {(ops.b, nlev)} "
                         "on the coords' device")
    for lvl, w in zip(rows, ops.widths):
        if (lvl.device != device or lvl.dtype != want
                or lvl.shape != (npix, w) or not lvl.is_contiguous()):
            raise ValueError(f"corr levels must be contiguous (B*H*W1, width) {want} "
                             "rows on the coords' device")
    mode = 2 if ops.pack8 else int(dtype == torch.bfloat16)
    args = ((ctypes.c_void_p * nlev)(*[lvl.data_ptr() for lvl in rows]),
            (ctypes.c_int * nlev)(*ops.widths), mode,
            None if scales is None else scales.data_ptr())
    ops._kernel_args = _KernelArgs(device, tuple(rows), scales, args)
    return args


def lookup_grad_plain(widths, radius: int, coords_x: torch.Tensor, grad: torch.Tensor,
                      dtype: torch.dtype) -> List[torch.Tensor]:
    """The gradient of :func:`lookup_plain` in each level's rows, given the
    taps' cotangent ``grad`` (B, H, W1, L*(2r+1)): tap k of level l spreads
    ``(1 - frac)`` of its cotangent to position ``i0 - r + k`` and ``frac``
    to the next, within the true width, summed in fp32 and rounded once to
    ``dtype``. A pixel's 2r+2 positions are distinct and lie in its own
    row, so each row is written by one scatter into a padded copy."""
    coords = coords_x.reshape(-1).float()
    npix, k = coords.shape[0], 2 * radius + 1
    g = grad.reshape(npix, len(widths), k).float()
    pad = 2 * radius + 2  # the clamped window reaches 2r+2 past either end
    offsets = torch.arange(-radius, radius + 2, device=coords.device)
    zero = g.new_zeros(npix, 1)
    out = []
    for i, w2 in enumerate(widths):
        cl = coords / (2 ** i)
        i0 = torch.floor(cl)
        frac = (cl - i0)[:, None]
        i0 = torch.clamp(i0, -radius - 2, w2 + radius + 1).long()
        gi = g[:, i]
        taps = torch.cat([gi, zero], 1) * (1.0 - frac) + torch.cat([zero, gi], 1) * frac
        buf = g.new_zeros(npix, w2 + 2 * pad + 1)
        buf.scatter_(1, i0[:, None] + offsets + pad, taps)
        out.append(buf[:, pad:pad + w2].to(dtype))
    return out


class _Lookup(torch.autograd.Function):
    """:func:`lookup_launch` forward, :func:`lookup_grad_plain` backward."""

    @staticmethod
    def forward(ctx, ops, coords_x, *levels):
        ctx.meta = (ops.widths, ops.radius, levels[0].dtype)
        ctx.save_for_backward(coords_x)
        return lookup_launch(ops, coords_x)

    @staticmethod
    def backward(ctx, grad):
        coords_x, = ctx.saved_tensors
        widths, radius, dtype = ctx.meta
        return (None, None, *lookup_grad_plain(widths, radius, coords_x, grad, dtype))


def lookup(ops: CorrOperands, coords_x: torch.Tensor) -> torch.Tensor:
    """:func:`lookup_launch`, differentiable in ``ops.levels`` (the JAX
    package's ``_lookup``): its backward is :func:`lookup_grad_plain`."""
    if torch.is_grad_enabled() and any(lvl.requires_grad for lvl in ops.levels):
        return _Lookup.apply(ops, coords_x.detach(), *ops.levels)
    return lookup_launch(ops, coords_x)


def lookup_launch(ops: CorrOperands, coords_x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W1)`` fp32 x positions -> ``(B, H, W1, L*(2r+1))`` taps.

    CPU tensors take :func:`lookup_plain`; CUDA tensors launch the kernel or
    raise."""
    refuse_grad("corr_lookup", coords_x, ops.levels)
    if coords_x.device.type == "cpu":
        return lookup_plain(ops, coords_x)
    if coords_x.dtype != torch.float32 or coords_x.shape != (ops.b, ops.h, ops.w1):
        raise ValueError(f"coords_x must be fp32 of shape {(ops.b, ops.h, ops.w1)}, "
                         f"got {coords_x.dtype} {tuple(coords_x.shape)}")
    if not 0 <= ops.radius <= MAX_RADIUS:
        raise ValueError(f"the lookup kernel takes radius 0..{MAX_RADIUS}, got {ops.radius}")
    rows, widths, mode, scales = kernel_levels(ops, coords_x.device)
    coords = coords_x.contiguous()
    nlev = len(ops.levels)
    out = torch.empty((ops.b, ops.h, ops.w1, nlev * (2 * ops.radius + 1)),
                      dtype=ops.levels[0].dtype, device=coords.device)
    fn = kernels.entry("corr_lookup")
    kernels.check("corr_lookup", fn(
        coords.data_ptr(), rows, widths, nlev, ops.radius, ops.b * ops.h * ops.w1, mode,
        scales, ops.h * ops.w1, out.data_ptr(),
        torch.cuda.current_stream(coords.device).cuda_stream))
    kernels.count_launch("corr_lookup", "pack8" if ops.pack8 else None)
    return out


def corr_fn_from_operands(ops: CorrOperands):
    """The ``corr_fn(coords_x)`` closure over built operands."""

    def corr_fn(coords_x: torch.Tensor) -> torch.Tensor:
        return lookup(ops, coords_x)

    return corr_fn
