"""Gradients through the hand-written kernels.

The JAX package gives each kernel on its training path a ``custom_vjp``
whose forward is the Pallas kernel and whose backward is the vjp of an XLA
formulation of the same function (its "oracle"). Here the same split is a
``torch.autograd.Function``:

- forward: the kernel's dispatcher, unchanged (the CUDA kernel on CUDA
  tensors, its plain version on CPU tensors), so the launch counters count
  the training step's launches as they count inference's;
- backward: the plain torch version recomputed from the saved inputs with
  autograd (:func:`recompute`), or a written-out transpose
  (``corr/reg_cuda.py``'s lookup). The backward calls the plain function
  directly, never the dispatcher, on the tensors' own device.

Every other kernel entry (the resident iteration, the int8 lane and q8
entries, the encoder kernels' single launches) has no backward: reached
with grad enabled and an input that requires grad, it raises
(:func:`refuse_grad`) rather than hand back a result that silently cuts the
gradient.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def needs_grad(leaves: Sequence[Optional[torch.Tensor]]) -> bool:
    """Whether autograd records a call on ``leaves``: grad mode on and a
    leaf that requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in leaves)


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if ``kernel`` is reached in grad mode with an input that
    requires grad: its wrapper returns tensors without a ``grad_fn``."""
    flat = []
    for t in tensors:
        if isinstance(t, (tuple, list)):
            flat.extend(t)
        else:
            flat.append(t)
    if needs_grad(flat):
        raise RuntimeError(
            f"kernel {kernel} has no backward: it was reached with grad enabled and an "
            "input that requires grad (run it under torch.no_grad(), or take the "
            "differentiable entry)")


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


class _Recompute(torch.autograd.Function):
    """``run(*leaves)`` forward; backward through ``plain(*leaves)``."""

    @staticmethod
    def forward(ctx, run, plain, single, *leaves):
        ctx.plain = plain
        ctx.save_for_backward(*leaves)
        outs = _as_tuple(run(*leaves))
        return outs[0] if single else outs

    @staticmethod
    def backward(ctx, *grads):
        leaves = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(t.requires_grad)
                      if isinstance(t, torch.Tensor) else t for t in leaves]
            outs = _as_tuple(ctx.plain(*inputs))
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o is not None and o.requires_grad]
            want = [i for i, t in enumerate(inputs)
                    if isinstance(t, torch.Tensor) and t.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], [inputs[i] for i in want],
                                      [g for _, g in pairs], allow_unused=True) if pairs else ()
        out = [None] * len(leaves)
        for i, g in zip(want, got):
            out[i] = g
        return (None, None, None, *out)


def recompute(run: Callable, plain: Callable, leaves: Sequence[Optional[torch.Tensor]],
              single: bool = False):
    """``run(*leaves)``, differentiable through ``plain(*leaves)`` when grad
    is enabled and a leaf requires grad; plain ``run`` otherwise. ``run``
    and ``plain`` return one tensor (``single``) or a tuple of tensors of
    the same structure."""
    if not needs_grad(leaves):
        return run(*leaves)
    return _Recompute.apply(run, plain, single, *leaves)
