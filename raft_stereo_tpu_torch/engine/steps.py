"""The train and eval steps (the JAX package's ``engine/steps.py``).

A train step is the reference's inner loop (``train_stereo.py:162-179``):
the train-mode forward, the sequence loss, the backward, the global-norm
clip, then AdamW and the OneCycle schedule, skipped when a gradient is not
finite (``engine/optimizer.py``). Every metric comes back to the host in one
fetch (one ``torch.stack(...).tolist()``), as the JAX package's loop fetches
them: the host's only wait on the card in a step.

With a :class:`~raft_stereo_tpu_torch.obs.ledger.ProgramLedger` the first
step records the row that stands in for the JAX package's ``AotLedgerFn``:
kind ``train_step``, its peak device bytes (``argument_bytes`` what was
allocated at the step's start, ``temp_bytes`` the rest of its peak) and, in
``launches``, the step's kernel launches by kernel (``kernels.launches``
counted over it).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, Optional

import torch

from raft_stereo_tpu_torch import kernels
from raft_stereo_tpu_torch.engine.loss import sequence_loss
from raft_stereo_tpu_torch.engine.optimizer import TrainOptimizer
from raft_stereo_tpu_torch.models.raft_stereo import raft_stereo_forward


class TrainStep:
    """``step(batch) -> metrics``: batch holds ``image1``, ``image2`` (B, H,
    W, 3), ``flow`` (B, H, W, 1) and ``valid`` (B, H, W) on the model's
    device; metrics are host floats. ``timing`` adds ``fwd_bwd_ms`` and
    ``optimizer_ms`` (CUDA events on the card, a second wait a step)."""

    def __init__(self, model: torch.nn.Module, optimizer: TrainOptimizer, train_iters: int,
                 ledger=None, timing: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.train_iters = train_iters
        self.ledger = ledger
        self.timing = timing
        self.launches: Optional[Dict[str, int]] = None  # the first step's, by kernel

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        dev = batch["image1"].device
        cuda = dev.type == "cuda"
        first = self.launches is None
        if first:
            before = Counter(kernels.launches)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
                at_start = torch.cuda.memory_allocated(dev)
        marks = self._mark(cuda)
        self.optimizer.zero_grad()
        preds = self.model(batch["image1"], batch["image2"], iters=self.train_iters,
                           test_mode=False)
        loss, metrics = sequence_loss(preds, batch["flow"], batch["valid"])
        loss.backward()
        grad_norm, finite = self.optimizer.clip()
        marks += self._mark(cuda)
        names = sorted(metrics) + ["loss", "grad_norm", "grads_finite"]
        values = [metrics[k] for k in sorted(metrics)] + [loss.detach(), grad_norm,
                                                           finite.float()]
        host = dict(zip(names, torch.stack([v.float() for v in values]).tolist()))
        applied = self.optimizer.step(host["grads_finite"] > 0.5)
        marks += self._mark(cuda)
        opt = self.optimizer
        if opt.skip_nonfinite > 0:
            host["skipped"] = 0.0 if opt.last_finite else 1.0
            host["notfinite_count"] = float(opt.notfinite_count)
            host["total_notfinite"] = float(opt.total_notfinite)
        host["applied"] = float(applied)
        if self.timing:
            host.update(self._times(marks, cuda))
        if first:
            self.launches = dict(Counter(kernels.launches) - before)
            if self.ledger is not None:
                self._record(batch, dev, cuda, at_start if cuda else None)
        return host

    @staticmethod
    def _mark(cuda: bool) -> list:
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return [ev]
        return [time.perf_counter()]

    @staticmethod
    def _times(marks: list, cuda: bool) -> Dict[str, float]:
        if cuda:
            marks[-1].synchronize()
            return {"fwd_bwd_ms": marks[0].elapsed_time(marks[1]),
                    "optimizer_ms": marks[1].elapsed_time(marks[2])}
        return {"fwd_bwd_ms": 1e3 * (marks[1] - marks[0]),
                "optimizer_ms": 1e3 * (marks[2] - marks[1])}

    def _record(self, batch, dev, cuda: bool, at_start) -> None:
        b, h, w = batch["image1"].shape[:3]
        analysis = {}
        if cuda:
            peak = torch.cuda.max_memory_allocated(dev)
            analysis = {"argument_bytes": float(at_start), "output_bytes": 0.0,
                        "temp_bytes": float(peak - at_start)}
        self.ledger.record(("train_step", self.train_iters), kind="train_step", b=b, h=h,
                           w=w, iters=self.train_iters, scan_scale=1, analysis=analysis,
                           backend=dev.type,
                           device_kind=torch.cuda.get_device_name(dev) if cuda else None)


def make_train_step(model: torch.nn.Module, optimizer: TrainOptimizer, train_iters: int,
                    ledger=None, timing: bool = False) -> TrainStep:
    """The JAX package's ``make_train_step``: ``step(batch) -> metrics``."""
    return TrainStep(model, optimizer, train_iters, ledger=ledger, timing=timing)


def make_eval_step(model: torch.nn.Module, valid_iters: int):
    """``eval_step(image1, image2) -> (flow_low, flow_up)``, the test-mode
    forward."""

    def step(image1: torch.Tensor, image2: torch.Tensor):
        return raft_stereo_forward(model, image1, image2, iters=valid_iters)

    return step


