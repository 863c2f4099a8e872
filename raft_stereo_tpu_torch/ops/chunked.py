"""Bounded-memory mapping over one axis in fixed-size chunks (the JAX
package's ``lax.map`` helper, as a Python loop)."""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F


def map_chunked(fn: Callable[[Tuple[torch.Tensor, ...]], torch.Tensor],
                inputs: Sequence[torch.Tensor], chunk: int, axis: int = 0) -> torch.Tensor:
    """``fn`` over ``axis`` of every input, ``chunk`` rows at a time.

    ``fn`` takes a tuple of slices in the inputs' layout with ``axis`` cut
    to ``chunk`` and returns a tensor with the chunked axis at the same
    position. The last chunk is zero-padded to ``chunk`` rows, and what
    ``fn`` makes of the padding is sliced off, never mixed into real rows.
    """
    inputs = tuple(inputs)
    n = inputs[0].shape[axis]
    if n <= chunk:
        return fn(inputs)
    pad = (-n) % chunk
    if pad:
        def zero_pad(x):
            widths = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [0, pad]
            return F.pad(x, widths)
        inputs = tuple(zero_pad(x) for x in inputs)
    outs = [fn(tuple(x.narrow(axis, s, chunk) for x in inputs))
            for s in range(0, n + pad, chunk)]
    return torch.cat(outs, dim=axis).narrow(axis, 0, n)
