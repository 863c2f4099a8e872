"""Halo rows between the ranks of a space row (height sharding).

The counterpart of the JAX package's ``_exchange_halo`` (``ops/
pallas_stream.py``), whose ``ppermute`` XLA differentiates by itself. Here
the exchange is a ``torch.autograd.Function`` with its transpose written
out: the forward sends each rank's top ``k`` rows to the rank above and its
bottom ``k`` rows to the rank below; the backward sends each halo's
gradient back to the rank it came from, which adds it onto the edge rows it
sent.

:func:`exchange_halo` gives ``(B, hl + 2k, W, C)`` with zero rows beyond the
image's top and bottom edges. The JAX package pads the extended map to a
multiple of 8 rows (its sublane rule); the port's kernels take any height,
so nothing is padded here.

A chain of convolutions over an extended map would read its own outputs in
those zero rows, where the unsharded map reads zero padding. So
:func:`extend_rows` drops them again at the image edges: the map then ends
where the image ends and each convolution pads it there itself, exactly as
on the whole map. Inside the image, ``k`` rows cover a chain whose
receptive field reaches ``k`` rows; the outputs' halo rows are cropped.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from raft_stereo_tpu_torch.parallel import comm

# Rows the kernels' spatial entries exchange: the deepest chain, the GRU
# (2 rows) and the FlowHead (2 more), fits; so does the motion encoder (5).
HALO = 8


def _swap(grid, to_prev: torch.Tensor, to_next: torch.Tensor):
    return comm.swap_with_neighbours(to_prev.contiguous(), to_next.contiguous(),
                                     grid.prev_rank(), grid.next_rank(), grid.backend,
                                     grid.space_group)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, grid):
        ctx.k, ctx.grid = k, grid
        up, dn = _swap(grid, x[:, :k], x[:, -k:])
        return torch.cat([up, x, dn], dim=1)

    @staticmethod
    def backward(ctx, g):
        k = ctx.k
        # The halo rows' gradients go back where the rows came from; what
        # comes back is the gradient of this rank's own edge rows.
        top, bottom = _swap(ctx.grid, g[:, :k], g[:, -k:])
        gx = g[:, k:-k].clone()
        gx[:, :k] += top
        gx[:, -k:] += bottom
        return gx, None, None


def exchange_halo(x: torch.Tensor, k: int, grid) -> torch.Tensor:
    """(B, hl, ...) -> (B, hl + 2k, ...): ``k`` rows of the neighbours on
    each side, zeros beyond the image's edges. Differentiable."""
    if not 0 < k <= x.shape[1]:
        raise ValueError(f"a halo of {k} rows needs 1..{x.shape[1]} local rows")
    return _Exchange.apply(x, k, grid)


def extend_rows(x: torch.Tensor, k: int, grid) -> Tuple[torch.Tensor, int]:
    """``(x_ext, top)``: ``x`` with ``k`` neighbour rows on each side that
    has a neighbour (none beyond the image's edges), and the number of rows
    added above. Contiguous."""
    ext = exchange_halo(x, k, grid)
    s, ns = grid.space_index, grid.n_space
    lo = k if s == 0 else 0
    hi = ext.shape[1] - (k if s == ns - 1 else 0)
    return ext[:, lo:hi].contiguous(), k - lo


def run_extended(fn: Callable, k: int, grid, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` over the maps ``xs`` (one height) extended by
    :func:`extend_rows`, its output map cropped back to the local rows: the
    unsharded ``fn``'s rows wherever its receptive field reaches at most
    ``k`` rows."""
    hl = xs[0].shape[1]
    ext = [extend_rows(x, k, grid) for x in xs]
    top = ext[0][1]
    return fn(*(e for e, _ in ext))[:, top:top + hl]
