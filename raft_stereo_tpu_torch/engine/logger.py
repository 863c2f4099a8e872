"""Training logger: running means to TensorBoard and the log (the JAX
package's ``engine/logger.py``, reference ``train_stereo.py:82-129``).

Scalars are flushed every ``SUM_FREQ=100`` steps from running means that
divide by the pushes that carried the key (skipped non-finite steps push
none), plus per-step ``live_loss`` and ``learning_rate`` and ``write_dict``
for validation results. The writer is tensorboardX where it imports, made
at first use; without it the scalars go to ``<log_dir>/scalars.jsonl``, one
``{"step", "tag", "value"}`` object a line. With a ``MetricsRegistry``
(``obs/metrics.py``) every push also feeds ``raft_train_*`` series, and
``close`` writes their Prometheus snapshot to ``<log_dir>/metrics.prom``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

SUM_FREQ = 100

logger = logging.getLogger(__name__)


class _JsonlWriter:
    """SummaryWriter-shaped fallback: newline-delimited JSON scalars."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        # Line-buffered: scalars survive crash/SIGKILL paths that never
        # reach close() (the "never silently dropped" promise above).
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                       buffering=1)

    def add_scalar(self, tag: str, value, step) -> None:
        self._f.write(json.dumps(
            {"step": int(step), "tag": tag, "value": float(value)}) + "\n")

    def close(self) -> None:
        self._f.close()


class Logger:
    def __init__(self, log_dir: str = "runs", scheduler=None,
                 registry=None):
        self.log_dir = log_dir
        self.scheduler = scheduler
        # graftscope (obs/metrics.py): when a MetricsRegistry is attached,
        # every push also lands in raft_train_* series — a steps counter,
        # a bounded step-wall-time histogram (the steps/s behind the
        # trajectory gate's training metric) and a last-value gauge per
        # scalar — and close() writes the Prometheus snapshot next to the
        # TensorBoard events (<log_dir>/metrics.prom), so a training run's
        # telemetry has the same shape as the serving stack's /metrics.
        self.registry = registry
        self._last_push_t = None
        if registry is not None:
            self._m_steps = registry.counter(
                "raft_train_steps_total", "train-loop steps pushed")
            self._step_hist = registry.histogram(
                "raft_train_step_seconds",
                "wall time between metric pushes (bounded reservoir)",
                reservoir=512)
        self.total_steps = 0
        # Steps whose update was skipped (non-finite grads) don't advance
        # the optimizer's schedule position; the train loop keeps this at
        # the wrapper's total_notfinite so the console LR reads the
        # schedule where the optimizer actually is.
        self.schedule_offset = 0
        self.running_loss: Dict[str, float] = {}
        self.running_count: Dict[str, int] = {}
        self.writer = None

    def _ensure_writer(self):
        if self.writer is None:
            try:
                from tensorboardX import SummaryWriter
                self.writer = SummaryWriter(log_dir=self.log_dir)
            except ImportError:
                self.writer = _JsonlWriter(self.log_dir)
        return self.writer

    def _print_training_status(self):
        metrics_data = [self.running_loss[k] / self.running_count[k]
                        for k in sorted(self.running_loss.keys())]
        lr = (float(self.scheduler(self.total_steps - self.schedule_offset))
              if self.scheduler is not None else float("nan"))
        metrics_str = ("{:10.4f}, " * len(metrics_data)).format(*metrics_data)
        logger.info("[%6d, %10.7f] %s", self.total_steps + 1, lr, metrics_str)

        writer = self._ensure_writer()
        for k in self.running_loss:
            writer.add_scalar(k, self.running_loss[k] / self.running_count[k],
                              self.total_steps)
            self.running_loss[k] = 0.0

    def push(self, metrics: Dict[str, float]):
        self.total_steps += 1
        if self.registry is not None:
            import time
            now = time.monotonic()
            self._m_steps.inc()
            if self._last_push_t is not None:
                self._step_hist.observe(now - self._last_push_t)
            self._last_push_t = now
            for key, value in metrics.items():
                self.registry.gauge(
                    "raft_train_metric", "last pushed train scalar",
                    key=key).set(float(value))
        for key, value in metrics.items():
            self.running_loss[key] = self.running_loss.get(key, 0.0) + float(value)
            self.running_count[key] = self.running_count.get(key, 0) + 1
        if self.total_steps % SUM_FREQ == SUM_FREQ - 1:
            self._print_training_status()
            self.running_loss = {}
            self.running_count = {}

    def write_scalar(self, name: str, value: float, step: Optional[int] = None):
        self._ensure_writer().add_scalar(
            name, value, self.total_steps if step is None else step)

    def write_dict(self, results: Dict[str, float]):
        writer = self._ensure_writer()
        for key, value in results.items():
            writer.add_scalar(key, value, self.total_steps)

    def close(self):
        if self.registry is not None and self.total_steps:
            try:
                os.makedirs(self.log_dir, exist_ok=True)
                with open(os.path.join(self.log_dir, "metrics.prom"),
                          "w") as f:
                    f.write(self.registry.render_prometheus())
            except OSError:  # telemetry must never kill a finished run
                logger.exception("could not write metrics.prom")
        if self.writer is not None:
            self.writer.close()
