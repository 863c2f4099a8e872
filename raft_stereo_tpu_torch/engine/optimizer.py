"""The optimizer: AdamW + OneCycle (linear) + global-norm clipping, with the
skip-if-nonfinite policy.

The reference's own classes (``train_stereo.py:72-79``):
``torch.optim.AdamW(lr, weight_decay=wdecay, eps=1e-8)`` stepped by
``OneCycleLR(lr, num_steps + 100, pct_start=0.01, cycle_momentum=False,
anneal_strategy='linear')``, the gradients clipped to a global norm of 1.0.
The JAX package's schedule (:func:`onecycle_linear_schedule`) was built to
match torch's, and the clip is optax's ``clip_by_global_norm``:
``g * max_norm / max(norm, max_norm)``, without torch's ``1e-6``.

:class:`TrainOptimizer` also carries optax's ``apply_if_finite`` semantics
(the JAX package's ``make_optimizer(skip_nonfinite=N)``): a step whose
gradients are not all finite leaves the parameters, the Adam moments and the
schedule position untouched and counts ``notfinite_count`` (consecutive) and
``total_notfinite``; once more than ``N`` consecutive steps were skipped the
update is applied anyway, as optax does (the train loop aborts at exactly
``N``, before that). Its counters are part of :meth:`state_dict`, which a
checkpoint holds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch


def onecycle_linear_schedule(max_lr: float, total_steps: int, pct_start: float = 0.01,
                             div_factor: float = 25.0, final_div_factor: float = 1e4):
    """torch's ``OneCycleLR`` with ``anneal_strategy='linear'`` as a function
    of the step (the JAX package's schedule, in Python floats)."""
    initial = max_lr / div_factor
    min_lr = initial / final_div_factor
    up = float(pct_start * total_steps) - 1.0
    down = float(total_steps) - 1.0 - up

    def schedule(step) -> float:
        step = float(step)
        if step <= up:
            return initial + min(max(step / max(up, 1e-8), 0.0), 1.0) * (max_lr - initial)
        return max_lr + min(max((step - up) / max(down, 1e-8), 0.0), 1.0) * (min_lr - max_lr)

    return schedule


class TrainOptimizer:
    """AdamW + OneCycle over ``params``, with clipping and the skip policy
    (``skip_nonfinite`` > 0; 0 applies every step)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, num_steps: int,
                 wdecay: float = 1e-5, eps: float = 1e-8, clip_norm: float = 1.0,
                 skip_nonfinite: int = 0):
        self.params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=eps,
                                       weight_decay=wdecay)
        self.schedule = torch.optim.lr_scheduler.OneCycleLR(
            self.adamw, lr, total_steps=num_steps + 100, pct_start=0.01,
            cycle_momentum=False, anneal_strategy="linear")
        self.clip_norm = float(clip_norm)
        self.skip_nonfinite = int(skip_nonfinite)
        self.notfinite_count = 0
        self.total_notfinite = 0
        self.last_finite = True

    @property
    def lr(self) -> float:
        """The learning rate the next applied step uses."""
        return float(self.adamw.param_groups[0]["lr"])

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def clip(self):
        """Scale the gradients to a global L2 norm of at most ``clip_norm``.
        Returns ``(norm, finite)``: the norm before clipping and whether
        every gradient is finite, 0-d tensors on the device, not fetched. A
        parameter without a gradient counts as zero."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norms = torch.stack([n.float() for n in torch._foreach_norm(grads, 2.0)])
        norm = torch.linalg.vector_norm(norms, 2.0)
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        torch._foreach_mul_(grads, scale)
        return norm, torch.isfinite(norms).all()

    def step(self, grads_finite: bool) -> bool:
        """The host's decision on one step, given whether every gradient was
        finite: apply AdamW and advance the schedule, or skip. Returns
        whether the update was applied."""
        if self.skip_nonfinite <= 0:
            apply = True
        else:
            self.last_finite = bool(grads_finite)
            if grads_finite:
                self.notfinite_count = 0
            else:
                self.notfinite_count += 1
                self.total_notfinite += 1
            apply = grads_finite or self.notfinite_count > self.skip_nonfinite
        if apply:
            self.adamw.step()
            self.schedule.step()
        return apply

    def state_dict(self) -> Dict:
        sched = {k: v for k, v in self.schedule.state_dict().items()
                 if isinstance(v, (int, float, bool, str, list, tuple, type(None)))}
        return {"adamw": self.adamw.state_dict(), "schedule": sched,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite,
                "last_finite": self.last_finite}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        sched = self.schedule.state_dict()
        sched.update(state["schedule"])
        self.schedule.load_state_dict(sched)
        self.notfinite_count = int(state.get("notfinite_count", 0))
        self.total_notfinite = int(state.get("total_notfinite", 0))
        self.last_finite = bool(state.get("last_finite", True))


def make_optimizer(model: torch.nn.Module, lr: float, num_steps: int, wdecay: float = 1e-5,
                   eps: float = 1e-8, clip_norm: float = 1.0,
                   skip_nonfinite: int = 0) -> TrainOptimizer:
    """The reference's optimizer stack over ``model``'s trainable parameters
    (BatchNorm's running statistics are buffers and not among them)."""
    return TrainOptimizer(model.parameters(), lr, num_steps, wdecay, eps, clip_norm,
                          skip_nonfinite)
