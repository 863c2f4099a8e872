"""Correlation implementations behind one protocol.

``make_corr_fn(impl, fmap1, fmap2, num_levels, radius, out_dtype)`` returns
``corr_fn(coords_x) -> (B, H, W1, num_levels * (2r+1))`` for ``coords_x`` of
shape ``(B, H, W1)``, level-major then offset ``-r..r``:

- ``reg``: fp32 volume and pyramid, plain torch lookup (:mod:`.reg`);
- ``reg_cuda`` (alias ``reg_tpu``): the volume in the fmap dtype and the
  hand-written CUDA lookup (:mod:`.reg_cuda`).
"""

from __future__ import annotations

from raft_stereo_tpu_torch.config import CORR_ALIASES
from raft_stereo_tpu_torch.corr.reg import make_reg_corr_fn


def make_corr_fn(impl: str, fmap1, fmap2, *, num_levels: int = 4,
                 radius: int = 4, out_dtype=None):
    impl = CORR_ALIASES.get(impl, impl)
    if impl == "reg":
        return make_reg_corr_fn(fmap1, fmap2, num_levels=num_levels,
                                radius=radius, out_dtype=out_dtype)
    if impl == "reg_cuda":
        from raft_stereo_tpu_torch.corr.reg_cuda import (
            build_corr_operands, corr_fn_from_operands)
        return corr_fn_from_operands(build_corr_operands(
            fmap1, fmap2, num_levels=num_levels, radius=radius,
            out_dtype=out_dtype))
    raise NotImplementedError(f"corr implementation {impl!r} is not ported")
