"""Correlation implementations behind one protocol.

``make_corr_fn(impl, fmap1, fmap2, num_levels, radius, out_dtype)`` returns
``corr_fn(coords_x) -> (B, H, W1, num_levels * (2r+1))`` for ``coords_x`` of
shape ``(B, H, W1)``, level-major then offset ``-r..r``:

- ``reg``: fp32 volume and pyramid, plain torch lookup (:mod:`.reg`);
- ``reg_cuda`` (alias ``reg_tpu``): the volume in the fmap dtype and the
  hand-written CUDA lookup (:mod:`.reg_cuda`);
- ``alt``: no volume, pooled fmap2 rows sampled and dotted per lookup, fp32
  (:mod:`.alt`);
- ``alt_cuda`` (alias ``alt_tpu``): the same in the fmap dtype with the
  hand-written CUDA alt kernel (:mod:`.alt_cuda`).

``make_corr`` returns the same closure and, for ``reg_cuda``, the pyramid
operands it reads, which the resident iteration kernel gathers from itself
(the JAX package's ``build_corr_operands`` + ``corr_fn_from_operands``).
The alt choices have none, so the resident kernel does not engage with
them, as in the JAX package.
"""

from __future__ import annotations

from raft_stereo_tpu_torch.config import CORR_ALIASES
from raft_stereo_tpu_torch.corr.alt import make_alt_corr_fn
from raft_stereo_tpu_torch.corr.alt_cuda import make_alt_cuda_corr_fn
from raft_stereo_tpu_torch.corr.reg import make_reg_corr_fn
from raft_stereo_tpu_torch.corr.reg_cuda import build_corr_operands, corr_fn_from_operands


def make_corr(impl: str, fmap1, fmap2, *, num_levels: int = 4, radius: int = 4,
              out_dtype=None):
    """``(corr_fn, operands)``; ``operands`` is the ``reg_cuda``
    :class:`~.reg_cuda.CorrOperands`, ``None`` for the others."""
    impl = CORR_ALIASES.get(impl, impl)
    kw = dict(num_levels=num_levels, radius=radius, out_dtype=out_dtype)
    if impl == "reg":
        return make_reg_corr_fn(fmap1, fmap2, **kw), None
    if impl == "alt":
        return make_alt_corr_fn(fmap1, fmap2, **kw), None
    if impl == "alt_cuda":
        return make_alt_cuda_corr_fn(fmap1, fmap2, **kw), None
    if impl == "reg_cuda":
        ops = build_corr_operands(fmap1, fmap2, **kw)
        return corr_fn_from_operands(ops), ops
    raise NotImplementedError(f"corr implementation {impl!r} is not ported")


def make_corr_fn(impl: str, fmap1, fmap2, *, num_levels: int = 4,
                 radius: int = 4, out_dtype=None):
    return make_corr(impl, fmap1, fmap2, num_levels=num_levels, radius=radius,
                     out_dtype=out_dtype)[0]
