"""Linear sampling of rows at fractional positions, zero outside the row
(``grid_sample`` with ``align_corners=True`` and zero padding, as the
reference's ``bilinear_sampler`` uses it on 1-D rows, ``core/utils/
utils.py:59-73``).

A sample at x is ``(1 - frac) * v[floor(x)] + frac * v[floor(x) + 1]``, each
tap zero where its index falls outside ``[0, W - 1]``. The JAX package
builds this as a one-hot reduce (its TPU form); here the two taps are
gathered. Positions and weights are fp32; the weights are cast to the
values' dtype before the product, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _taps(x: torch.Tensor, width: int) -> Tuple[torch.Tensor, ...]:
    """The two tap indices (clamped into the row) and their weights (zero
    for a tap outside it) of fractional positions ``x``."""
    x = x.float()
    x0 = torch.floor(x)
    frac = x - x0
    i0 = x0.long()
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < width), 1.0 - frac, torch.zeros_like(frac))
    w1 = torch.where((i1 >= 0) & (i1 < width), frac, torch.zeros_like(frac))
    return i0.clamp(0, width - 1), i1.clamp(0, width - 1), w0, w1


def sample_1d_zeros(values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample rows of scalars at fractional positions.

    values: (..., W); x: (..., K), the same leading dims. Returns (..., K).
    """
    i0, i1, w0, w1 = _taps(x, values.shape[-1])
    return (values.gather(-1, i0) * w0.to(values.dtype)
            + values.gather(-1, i1) * w1.to(values.dtype))


def sample_rows_zeros(fmap: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample feature rows at fractional positions.

    fmap: (..., W, D); x: (..., K), the same leading dims. Returns
    (..., K, D).
    """
    d = fmap.shape[-1]
    i0, i1, w0, w1 = _taps(x, fmap.shape[-2])

    def rows(i):
        return fmap.gather(-2, i[..., None].expand(*i.shape, d))

    return (rows(i0) * w0[..., None].to(fmap.dtype)
            + rows(i1) * w1[..., None].to(fmap.dtype))
