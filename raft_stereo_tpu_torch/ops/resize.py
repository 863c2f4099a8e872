"""Aligned-corners bilinear resize as two banded-matrix contractions.

The JAX package (``ops/resize.py``) resizes with an (out, in) lerp matrix per
axis, two nonzeros per row, built in fp32 and rounded to the input dtype,
then contracted with fp32 accumulation and rounded once per axis.
``F.interpolate(align_corners=True)`` computes ``a + (b - a) * w`` instead
and is not value-equal in bf16, so the matrix form is kept.

Under a height shard (``space``) an output row ``o`` reads the input rows
``floor(o * (h - 1) / (oh - 1))`` and the one after. A shard's output rows
reach at most :func:`halo_rows` input rows past its own input rows, which
it takes from its neighbours (``ops/halo.py``), and it contracts them with
its block of the same matrix: each output value sums the same two products
as on the whole map.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch


def _lerp_index(in_size: int, out_size: int, device: torch.device):
    """Per output position: the lower source index, the upper one (the same
    at the last position) and the fp32 weight of the upper one."""
    if out_size == 1:
        src = torch.zeros(1, dtype=torch.float32, device=device)
    else:
        scale = (in_size - 1) / (out_size - 1)
        src = torch.arange(out_size, dtype=torch.float32, device=device) * scale
    lo = torch.clamp(torch.floor(src), 0, in_size - 1).long()
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    return lo, hi, src - lo.float()


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def _lerp_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(out, in) aligned-corners lerp matrix, rounded to ``dtype`` and held
    in fp32. Cached: it depends only on its arguments, the refinement loop
    asks for the same four every iteration, and building one takes some
    forty small launches on a GPU. Callers only read it. The cached tensors
    are built outside inference mode: one made under ``inference_mode`` (an
    eager forward) could not be saved for a later backward in the same
    process."""
    lo, hi, wt = _lerp_index(in_size, out_size, device)
    m = torch.zeros(out_size, in_size, dtype=torch.float32, device=device)
    rows = torch.arange(out_size, device=device)
    m.index_put_((rows, lo), 1 - wt, accumulate=True)
    m.index_put_((rows, hi), wt, accumulate=True)
    return m.to(dtype).float()


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def lerp_taps(in_size: int, out_size: int, dtype: torch.dtype,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two nonzeros of each row of :func:`_lerp_matrix`: ``(idx, wt)``,
    (out, 2) int32 source indices and (out, 2) fp32 weights, read from the
    matrix itself, so each weight is the matrix's already-rounded entry
    (where both taps are one index, the last row, the summed entry and a
    zero). ``sum_k wt[o, k] * x[idx[o, k]]`` is row ``o`` of the matrix
    product. Cached like the matrix; the gru16+32 kernel upsamples with
    them."""
    m = _lerp_matrix(in_size, out_size, dtype, device)
    lo, hi, _ = _lerp_index(in_size, out_size, device)
    rows = torch.arange(out_size, device=device)
    w_hi = torch.where(hi != lo, m[rows, hi], torch.zeros((), device=device))
    idx = torch.stack([lo, hi], dim=-1).to(torch.int32).contiguous()
    return idx, torch.stack([m[rows, lo], w_hi], dim=-1).contiguous()


@functools.lru_cache(maxsize=64)
def halo_rows(in_size: int, out_size: int, ns: int) -> int:
    """Input rows beyond its own that any of ``ns`` equal shards reads
    (0 when the height is not resized)."""
    if in_size == out_size:
        return 0
    lo, hi, _ = _lerp_index(in_size, out_size, torch.device("cpu"))
    hl, ohl = in_size // ns, out_size // ns
    k = 0
    for s in range(ns):
        k = max(k, s * hl - int(lo[s * ohl]), int(hi[(s + 1) * ohl - 1]) - ((s + 1) * hl - 1))
    return k


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def _shard_matrix(in_size: int, out_size: int, ns: int, s: int, k: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """Shard ``s``'s block of :func:`_lerp_matrix`: its output rows over
    its input rows extended by ``k`` on each side (columns beyond the image
    are zero)."""
    m = _lerp_matrix(in_size, out_size, dtype, device)
    hl, ohl = in_size // ns, out_size // ns
    lo = s * hl - k
    out = torch.zeros(ohl, hl + 2 * k, dtype=torch.float32, device=device)
    a, b = max(lo, 0), min(lo + hl + 2 * k, in_size)
    out[:, a - lo:b - lo] = m[s * ohl:(s + 1) * ohl, a:b]
    return out


def interp_align_corners(x: torch.Tensor, size: Tuple[int, int], space=None) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) to (B, size[0], size[1], C),
    align_corners=True. With ``space`` (a ``ProcessGrid`` with a space
    axis) ``x`` is this rank's rows of a (B, H * ns, W, C) map, ``size``
    the whole output's, and the result this rank's rows of it."""
    b, h, w, c = x.shape
    oh, ow = size
    ns = 1 if space is None else space.n_space
    if (oh, ow) == (h * ns, w):
        return x
    out = x
    if ns > 1 and oh != h * ns:
        if oh % ns:
            raise ValueError(f"output height {oh} does not split over {ns} space ranks")
        from raft_stereo_tpu_torch.ops.halo import exchange_halo
        k = halo_rows(h * ns, oh, ns)
        xe = exchange_halo(x, k, space) if k else x
        m = _shard_matrix(h * ns, oh, ns, space.space_index, k, x.dtype, x.device)
        out = torch.einsum("Oh,bhwc->bOwc", m, xe.float()).to(x.dtype)
    elif oh != h * ns:
        m = _lerp_matrix(h, oh, x.dtype, x.device)
        out = torch.einsum("Oh,bhwc->bOwc", m, out.float()).to(x.dtype)
    if ow != w:
        m = _lerp_matrix(w, ow, x.dtype, x.device)
        out = torch.einsum("Pw,bOwc->bOPc", m, out.float()).to(x.dtype)
    return out.contiguous()
