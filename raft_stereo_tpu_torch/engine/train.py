"""The training loop (the JAX package's ``engine/train.py``, reference
``train_stereo.py:132-211``), on one card.

A step is :class:`~.steps.TrainStep` (forward, loss, backward, clip, AdamW +
OneCycle, skipped when a gradient is not finite) on batches from the loader
through :func:`~raft_stereo_tpu_torch.data.loader.device_prefetch`. As in
the JAX package: checkpoints hold the model, the optimizer (with its
schedule and skip counters) and the step, so a resume continues the
schedule; validation (FlyingThings) and a checkpoint every ``ckpt_every``
steps, keep-last-K over the periodic ones, a preempt bundle on SIGTERM
(:class:`PreemptGuard`), an epoch bundle after a long epoch, the final
bundle at the end; ``restore_ckpt`` may name a directory, resumed from its
newest valid bundle (the final one included). A run aborts after
``max_bad_steps`` consecutive non-finite steps, or on the first when the
update was applied. The ``faults`` hooks (``raft_stereo_tpu_torch/faults.py``)
drive every recovery path in the tests.

The port's additions: a resumed run's loader starts at the step's batch
(``StereoLoader.resume_at``), so resuming gives the uninterrupted run's
batches; each step's host metrics go to ``<log_dir>/steps.jsonl``; the
train step's ledger row and launches by kernel to ``<log_dir>/ledger.json``.

Data parallelism over several cards (the JAX package's mesh, its
``spatial_shard`` and its multi-host launch) is the next slice: with more
than one visible card, ``spatial_shard`` > 1 or ``COORDINATOR_ADDRESS`` set,
:func:`train` raises before it builds the model.
"""

from __future__ import annotations

import json
import logging
import math
import os
import signal
import time
from typing import Dict, Optional

import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig, resolve_device
from raft_stereo_tpu_torch.data.loader import device_prefetch, fetch_dataloader
from raft_stereo_tpu_torch.engine import checkpoint as ckpt
from raft_stereo_tpu_torch.engine.evaluate import count_parameters, validate_things
from raft_stereo_tpu_torch.engine.logger import Logger
from raft_stereo_tpu_torch.engine.optimizer import make_optimizer, onecycle_linear_schedule
from raft_stereo_tpu_torch.engine.steps import make_train_step
from raft_stereo_tpu_torch.models.raft_stereo import init_raft_stereo

logger = logging.getLogger(__name__)

NEXT_SLICE = ("training on more than one card (data parallelism over NCCL, height "
              "sharding) is not in raft_stereo_tpu_torch yet; it is the next slice")


def check_one_card(tcfg: TrainConfig, device: torch.device) -> None:
    """Raise where the run would need more than one card."""
    if tcfg.spatial_shard > 1:
        raise NotImplementedError(f"--spatial_shard {tcfg.spatial_shard}: {NEXT_SLICE}")
    if os.environ.get("COORDINATOR_ADDRESS"):
        raise NotImplementedError(f"COORDINATOR_ADDRESS is set: {NEXT_SLICE}")
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} cards are visible: {NEXT_SLICE} (make one "
            "visible with CUDA_VISIBLE_DEVICES)")


class PreemptGuard:
    """SIGTERM asks for a checkpoint and an exit: the handler only sets a
    flag, which the loop reads at a step boundary, where the state is
    consistent."""

    def __init__(self):
        self.requested = False
        self._prev = None
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
        except ValueError:  # not the main thread: polling still works
            pass

    def _on_signal(self, signum, frame):
        self.requested = True
        logger.warning("SIGTERM received: checkpointing at next step boundary")

    def stop(self, step: int = 0) -> bool:
        return self.requested

    def restore(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)


def _restore(tcfg: TrainConfig, model, optimizer, ckpt_dir: str):
    """Apply ``restore_ckpt``: returns ``(start_step, ckpt_dir)``."""
    restore = tcfg.restore_ckpt
    if restore is not None and os.path.isdir(restore):
        # Auto-resume from the directory's newest valid bundle of this run
        # (the final one too: a finished run's relaunch trains nothing);
        # new bundles go to the same directory.
        ckpt_dir = restore
        restore = ckpt.find_latest_checkpoint(restore, name=tcfg.name, include_final=True)
        if restore is None:
            logger.warning("no valid checkpoint under %s: starting fresh", ckpt_dir)
    if restore is None:
        return 0, ckpt_dir
    if restore.endswith(".pth"):
        ckpt.load_params(restore, model)
        logger.info("Loaded reference weights from %s", restore)
        return 0, ckpt_dir
    _, _, step = ckpt.load_checkpoint(restore, model, optimizer)
    logger.info("Restored full state from %s at step %d", restore, step)
    return step, ckpt_dir


def train(cfg: RAFTStereoConfig, tcfg: TrainConfig, data_root: Optional[str] = None,
          validate: bool = True, faults=None, device=None, log_dir: str = "runs",
          ckpt_dir: str = "checkpoints", timing: bool = False) -> Dict[str, float]:
    """Run the training loop. Returns the last validation results and the
    run's reliability counters (``skipped_steps``, ``quarantined_samples``)
    and its last ``step``.

    ``faults``: a :class:`raft_stereo_tpu_torch.faults.FaultPlan`, the
    injection harness of the tests. Each step's line in ``steps.jsonl``
    holds its metrics, ``data_ms`` (the wait for the batch) and ``wall_s``
    (seconds since the loop began, at the step's end); ``timing`` adds
    ``fwd_bwd_ms`` and ``optimizer_ms`` (a second wait a step)."""
    dev = resolve_device(device)
    check_one_card(tcfg, dev)
    ckpt.check_run_name(tcfg.name)
    model = init_raft_stereo(cfg, seed=tcfg.seed, device=dev)
    optimizer = make_optimizer(model, tcfg.lr, tcfg.num_steps, tcfg.wdecay,
                               skip_nonfinite=tcfg.max_bad_steps)
    start_step, ckpt_dir = _restore(tcfg, model, optimizer, ckpt_dir)
    logger.info("Parameter Count: %d", count_parameters(model))

    train_loader = fetch_dataloader(tcfg, root=data_root)
    train_loader.resume_at(start_step)
    if faults is not None:
        from raft_stereo_tpu_torch.faults import FaultyDataset
        train_loader.dataset = FaultyDataset(train_loader.dataset, faults)
    from raft_stereo_tpu_torch.obs.ledger import ProgramLedger
    from raft_stereo_tpu_torch.obs.metrics import MetricsRegistry
    ledger = ProgramLedger()
    train_step = make_train_step(model, optimizer, tcfg.train_iters, ledger=ledger,
                                 timing=timing)
    schedule = onecycle_linear_schedule(tcfg.lr, tcfg.num_steps + 100)
    log = Logger(log_dir=log_dir, scheduler=schedule, registry=MetricsRegistry())
    log.total_steps = start_step

    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)
    total_steps = start_step
    should_keep_training = start_step < tcfg.num_steps
    if not should_keep_training:
        logger.warning("restored step %d >= num_steps %d: nothing to train",
                       start_step, tcfg.num_steps)
    preempted = False
    last_results: Dict[str, float] = {}
    skipped_total = 0
    quarantine_seen = 0
    guard = PreemptGuard()
    image_dtype = torch.bfloat16 if cfg.mixed_precision else None
    steps_log = open(os.path.join(log_dir, "steps.jsonl"), "a", buffering=1)
    t_loop = time.perf_counter()

    def bundle(prefix: str) -> str:
        return os.path.join(ckpt_dir, f"{prefix}{tcfg.name}{ckpt.CKPT_SUFFIX}")

    try:
        while should_keep_training:
            epoch_batches = train_loader
            if faults is not None:
                from raft_stereo_tpu_torch.faults import poisoned_batches
                epoch_batches = poisoned_batches(train_loader, faults, start_step=total_steps)
            batches = device_prefetch(epoch_batches, dev, image_dtype=image_dtype)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                data_ms = 1e3 * (time.perf_counter() - t0)
                if tcfg.trace_dir is not None and total_steps == start_step + 2:
                    host = _profiled(train_step, batch, tcfg.trace_dir)
                else:
                    host = train_step(batch)
                steps_log.write(json.dumps({"step": total_steps, **host, "data_ms": data_ms,
                                            "wall_s": time.perf_counter() - t_loop}) + "\n")
                bad = (host.get("finite", 1.0) < 1.0 or host.get("skipped", 0.0) > 0.0
                       or not math.isfinite(host.get("loss", 0.0)))
                log.schedule_offset = int(host.get("total_notfinite", 0))
                if bad:
                    if not host.get("skipped", 0.0) > 0.0:
                        # No skip policy, or non-finite predictions with
                        # finite gradients: the update was applied, so the
                        # parameters are already suspect. Abort, as the
                        # reference does.
                        raise FloatingPointError(
                            f"non-finite loss/predictions at step {total_steps} with the "
                            f"update applied (loss={host.get('loss')})")
                    skipped_total += 1
                    consecutive_bad = int(host["notfinite_count"])
                    log.write_scalar("skipped_steps", skipped_total, total_steps)
                    log.push({})
                    logger.warning("non-finite step %d skipped (%d consecutive, %d total, "
                                   "loss=%s)", total_steps, consecutive_bad, skipped_total,
                                   host.get("loss"))
                    if consecutive_bad >= tcfg.max_bad_steps:
                        raise FloatingPointError(
                            f"non-finite loss/predictions at step {total_steps} "
                            f"({consecutive_bad} consecutive; loss={host.get('loss')})")
                else:
                    log.push({k: host[k] for k in ("epe", "1px", "3px", "5px", "loss")
                              if k in host})
                    log.write_scalar("live_loss", host["loss"], total_steps)
                    applied = total_steps - int(host.get("total_notfinite", 0))
                    log.write_scalar("learning_rate", schedule(applied), total_steps)
                nq = len(getattr(train_loader, "quarantined", ()))
                if nq != quarantine_seen:
                    quarantine_seen = nq
                    log.write_scalar("quarantined_samples", nq, total_steps)
                total_steps += 1
                if faults is not None:
                    from raft_stereo_tpu_torch.faults import fire_step_faults
                    fire_step_faults(faults, total_steps)

                if total_steps % tcfg.ckpt_every == 0:
                    path = ckpt.save_checkpoint(bundle(f"{total_steps}_"), model, optimizer,
                                                total_steps)
                    logger.info("Saved %s", path)
                    if tcfg.keep_ckpts > 0:
                        ckpt.prune_checkpoints(ckpt_dir, tcfg.name, keep=tcfg.keep_ckpts)
                    if validate:
                        last_results = validate_things(model, cfg, iters=tcfg.valid_iters,
                                                       root=data_root)
                        log.write_dict(last_results)

                if total_steps >= tcfg.num_steps:
                    should_keep_training = False
                    break
                if guard.stop(total_steps):
                    preempted = True
                    path = ckpt.save_checkpoint(bundle(f"{total_steps}_preempt_"), model,
                                                optimizer, total_steps)
                    logger.warning("Preempted: saved %s; resume with --restore_ckpt to "
                                   "continue the schedule", path)
                    should_keep_training = False
                    break
            batches.close()

            if len(train_loader) >= 10000:
                path = ckpt.save_checkpoint(bundle(f"{total_steps}_epoch_"), model, optimizer,
                                            total_steps)
                logger.info("Saved epoch checkpoint %s", path)

        if not preempted:
            path = ckpt.save_checkpoint(bundle(""), model, optimizer, total_steps)
            logger.info("Saved final checkpoint %s", path)
    finally:
        steps_log.close()
        log.close()
        guard.restore()
        if len(ledger):
            from raft_stereo_tpu_torch.obs.ledger import save_doc
            doc = ledger.to_doc(backend=dev.type, device_kind=(
                torch.cuda.get_device_name(dev) if dev.type == "cuda" else None))
            doc["train_step_launches"] = train_step.launches or {}
            try:
                save_doc(doc, os.path.join(log_dir, "ledger.json"))
            except OSError:
                logger.exception("could not write ledger.json (training result is "
                                 "unaffected)")
    quarantined = train_loader.quarantine_report()
    if quarantined:
        logger.warning("quarantine report: %d sample(s) substituted: %s", len(quarantined),
                       quarantined)
    return dict(last_results, skipped_steps=float(skipped_total),
                quarantined_samples=float(len(quarantined)), step=float(total_steps))


def _profiled(train_step, batch, trace_dir: str) -> Dict[str, float]:
    """One step under torch.profiler, its trace written to ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if batch["image1"].device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        host = train_step(batch)
    prof.export_chrome_trace(os.path.join(trace_dir, "train_step.json"))
    return host
