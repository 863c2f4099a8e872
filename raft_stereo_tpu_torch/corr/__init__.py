"""Correlation implementations behind one protocol.

``make_corr_fn(impl, fmap1, fmap2, num_levels, radius, out_dtype)`` returns
``corr_fn(coords_x) -> (B, H, W1, num_levels * (2r+1))`` for ``coords_x`` of
shape ``(B, H, W1)``, level-major then offset ``-r..r``:

- ``reg``: fp32 volume and pyramid, plain torch lookup (:mod:`.reg`);
- ``reg_cuda`` (alias ``reg_tpu``): the volume in the fmap dtype and the
  hand-written CUDA lookup (:mod:`.reg_cuda`).

``make_corr`` returns the same closure and, for ``reg_cuda``, the pyramid
operands it reads, which the resident iteration kernel gathers from itself
(the JAX package's ``build_corr_operands`` + ``corr_fn_from_operands``).
"""

from __future__ import annotations

from raft_stereo_tpu_torch.config import CORR_ALIASES
from raft_stereo_tpu_torch.corr.reg import make_reg_corr_fn


def make_corr(impl: str, fmap1, fmap2, *, num_levels: int = 4, radius: int = 4,
              out_dtype=None):
    """``(corr_fn, operands)``; ``operands`` is the ``reg_cuda``
    :class:`~.reg_cuda.CorrOperands`, ``None`` for ``reg``."""
    impl = CORR_ALIASES.get(impl, impl)
    if impl == "reg":
        return make_reg_corr_fn(fmap1, fmap2, num_levels=num_levels, radius=radius,
                                out_dtype=out_dtype), None
    if impl == "reg_cuda":
        from raft_stereo_tpu_torch.corr.reg_cuda import (
            build_corr_operands, corr_fn_from_operands)
        ops = build_corr_operands(fmap1, fmap2, num_levels=num_levels, radius=radius,
                                  out_dtype=out_dtype)
        return corr_fn_from_operands(ops), ops
    raise NotImplementedError(f"corr implementation {impl!r} is not ported")


def make_corr_fn(impl: str, fmap1, fmap2, *, num_levels: int = 4,
                 radius: int = 4, out_dtype=None):
    return make_corr(impl, fmap1, fmap2, num_levels=num_levels, radius=radius,
                     out_dtype=out_dtype)[0]
