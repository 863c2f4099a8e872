"""Prefetching batch loader (reference: torch ``DataLoader``, :311-312).

The reference leans on torch's fork-based DataLoader; here the loader is a
thread pool over the numpy-native dataset with deterministic per-sample RNG:

- sample ``i`` of epoch ``e`` is loaded with ``default_rng([seed, e, i])`` —
  reproducible regardless of worker count or scheduling (the reference's
  per-worker global reseeding makes runs depend on worker assignment);
- bounded in-flight futures give prefetch with backpressure;
- ``device_prefetch`` overlaps the host-to-device copy of batch N+1 with the
  step on batch N: pinned host tensors, ``non_blocking`` copies on a side
  CUDA stream, an event the consumer's stream waits on.

cv2/PIL decode and numpy augmentation release the GIL for their hot parts, so
threads keep an 8-chip slice fed without fork complexity; ``num_workers``
matches the reference's ``SLURM_CPUS_PER_TASK - 2`` sizing by default.

Fault tolerance (DESIGN.md "Failure recovery"): IO/decode errors retry with
bounded backoff; persistently-bad samples are quarantined for the run and
their batch slots filled by deterministic substitutes keyed off the same
``[seed, epoch, i]`` slot RNG, so one corrupt PNG/PFM costs one sample — not
the run — and multi-host batches stay identical.

Several processes (``local_rows``): each decodes only its slice of every
global batch, the rows its data index trains on
(``parallel/mesh.py:local_batch_rows``). The batch order and each sample's
augmentation depend on the seed, the epoch and the sample's place in the
global batch only, so the rows are those of the global batch one process
would load; the ranks of one space row decode the same rows.

The port's copy of the JAX package's ``data/loader.py``. One addition:
:meth:`StereoLoader.resume_at` places the loader at a training step (its
epoch, and the batch within it), so a run resumed from a checkpoint sees the
batches the uninterrupted run would have; the JAX package's resumed loader
starts again at epoch 0.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

import torch

from raft_stereo_tpu_torch.data.datasets import StereoDataset, fetch_dataset

logger = logging.getLogger(__name__)

ARRAY_KEYS = ("image1", "image2", "flow", "valid")

# Errors worth retrying/quarantining: filesystem hiccups (OSError covers
# PIL's UnidentifiedImageError and truncated-read IOErrors), decode failures
# (ValueError from the PFM/flow parsers), and cv2.imread's None-return
# arithmetic (TypeError). Anything else — shape bugs, OOM, KeyboardInterrupt
# — propagates: retrying a programming error hides it.
IO_RETRY_ERRORS = (OSError, ValueError, TypeError)

# Key-salt separating the substitute-candidate stream from the per-sample
# augmentation stream (both are keyed off [seed, epoch, position]).
_SUBSTITUTE_SALT = 0x5B5
# Distinct substitute candidates probed before giving up on a batch slot.
_SUBSTITUTE_TRIES = 32
# Quarantine is for ISOLATED corruption. IO_RETRY_ERRORS is deliberately
# broad (ValueError/TypeError also cover decode bugs reached through real
# files), so a systematic failure — an augmentation bug for a whole
# dataset, a dead mount — would otherwise be silently substituted away
# sample by sample. Cap the quarantine at this fraction of the dataset
# (floored at an absolute count so tiny datasets aren't over-strict) and
# abort loudly beyond it.
_MAX_QUARANTINE_FRAC = 0.01
_MAX_QUARANTINE_MIN = 16


def collate(samples, return_paths: bool = False) -> Dict[str, np.ndarray]:
    """Stack sample dicts into one batch dict of arrays.

    Paths are excluded by default, so every value of the batch is an array.
    """
    batch = {k: np.stack([s[k] for s in samples]) for k in ARRAY_KEYS
             if k in samples[0]}
    if return_paths:
        batch["paths"] = [s["paths"] for s in samples]
    return batch


class StereoLoader:
    """Iterable over shuffled, augmented, batched samples."""

    def __init__(self, dataset: StereoDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 4,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 return_paths: bool = False,
                 retries: int = 2, retry_backoff: float = 0.05,
                 local_rows: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        # This process's rows of each global batch (None: all of them).
        self.local_rows = local_rows
        # Fault tolerance (DESIGN.md "Failure recovery"): per-sample load
        # errors retry `retries` times with bounded exponential backoff;
        # a sample still failing after that is quarantined for the run and
        # its batch slot filled by a deterministic substitute.
        self.retries = max(0, retries)
        self.retry_backoff = retry_backoff
        self.quarantined: Dict[int, str] = {}
        # Worker threads quarantine concurrently; the lock keeps the
        # check-then-insert atomic and quarantine_report()'s copy safe
        # against a late in-flight _load mutating the dict mid-iteration.
        self._quarantine_lock = threading.Lock()
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.return_paths = return_paths
        self.epoch = 0
        self._skip = 0  # batches of the next epoch to leave out (resume_at)
        if drop_last and len(dataset) < batch_size:
            # A zero-batch loader would make train() spin forever in its
            # while-loop without ever advancing total_steps — fail fast.
            raise ValueError(
                f"drop_last=True leaves zero batches: dataset has "
                f"{len(dataset)} samples < batch_size {batch_size}")

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def resume_at(self, step: int) -> None:
        """Make the next iteration start at training step ``step``: epoch
        ``step // len(self)``, from batch ``step % len(self)`` of it (the
        batches before it are neither loaded nor yielded)."""
        self.epoch, self._skip = divmod(int(step), len(self))

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng([self.seed, epoch]).shuffle(order)
        return order

    def _load_once(self, index: int, epoch: int, position: int):
        """One sample with bounded retry; re-raises after retries exhaust.

        The RNG is re-derived from ``[seed, epoch, position]`` on every
        attempt, so a retried sample draws the *identical* augmentation
        stream — a transient IO fault that recovers within the retry budget
        yields a run bit-for-bit equal to the fault-free one.
        """
        last_err = None
        for attempt in range(self.retries + 1):
            rng = np.random.default_rng([self.seed, epoch, position])
            try:
                return self.dataset.__getitem__(int(index), rng=rng)
            except IO_RETRY_ERRORS as e:
                last_err = e
                if attempt < self.retries:
                    time.sleep(min(self.retry_backoff * (2 ** attempt), 2.0))
        raise last_err

    def _quarantine(self, index: int, err: BaseException) -> None:
        with self._quarantine_lock:
            if int(index) not in self.quarantined:
                self.quarantined[int(index)] = repr(err)
                logger.warning(
                    "quarantined sample %d after %d failed attempts (%r); "
                    "%d sample(s) quarantined so far",
                    index, self.retries + 1, err, len(self.quarantined))
            n = len(self.quarantined)
        limit = max(_MAX_QUARANTINE_MIN,
                    int(_MAX_QUARANTINE_FRAC * len(self.dataset)))
        if n > limit:
            # Last-resort abort, HOST-LOCAL by design: on a pod each process
            # decodes only its own rows, so a dead local mount trips the cap
            # here only — survivors exit via the distributed-runtime barrier
            # timeout at their next collective. Coordinating this abort at a
            # step boundary is impossible (the dying host never reaches one);
            # see DESIGN.md "Failure recovery".
            raise RuntimeError(
                f"{n} samples quarantined (limit "
                f"{limit}): this is a systematic data-pipeline failure "
                f"(bad mount, decode/augmentation bug), not isolated "
                f"corruption; last error: {err!r}")

    def quarantine_report(self) -> Dict[int, str]:
        """Quarantined dataset indices -> last error repr (copy)."""
        with self._quarantine_lock:
            return dict(self.quarantined)

    def _load(self, index: int, epoch: int, position: int):
        """Load batch slot ``position``: the scheduled sample, or — when it
        is persistently bad — a deterministic substitute.

        Substitutes are drawn from an RNG keyed off the same
        ``[seed, epoch, position]`` slot (plus a salt separating it from the
        augmentation stream), and a candidate is accepted or rejected by
        *content* (it must itself load within the retry budget). The local
        ``quarantined`` set is only a fast path past candidates already
        proven persistently bad — it never changes which candidate wins, so
        every run and every pod process fills the slot identically and
        multi-host batches stay batch-identical. (The retry budget is the
        transient/persistent boundary: a fault that exceeds it on one host
        but not another is by definition not transient.)
        """
        index = int(index)
        if index not in self.quarantined:
            try:
                return self._load_once(index, epoch, position)
            except IO_RETRY_ERRORS as e:
                self._quarantine(index, e)
        # Candidates are a seeded PERMUTATION (no duplicate or self draws
        # wasting tries), and a known-quarantined candidate consumes a try
        # just like probing-and-failing it would — so every host walks the
        # identical candidate sequence with the identical try budget whether
        # it learned a candidate was bad locally or not.
        order = np.random.default_rng(
            [self.seed, epoch, position, _SUBSTITUTE_SALT]).permutation(
                len(self.dataset))
        last_err: Optional[BaseException] = None
        tried = 0
        for j in order:
            j = int(j)
            if j == index:
                continue
            if tried >= _SUBSTITUTE_TRIES:
                break
            tried += 1
            if j in self.quarantined:
                continue  # counted: a content probe would fail identically
            try:
                return self._load_once(j, epoch, position)
            except IO_RETRY_ERRORS as e:
                self._quarantine(j, e)
                last_err = e
        raise RuntimeError(
            f"sample {index} is quarantined and none of {tried} "
            f"deterministic substitute candidates loaded") from last_err

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # Claim the epoch number up front: a partially-consumed iterator
        # (step-bounded training loop breaking early) must not replay the
        # identical shuffle + augmentations on the next pass.
        epoch = self.epoch
        self.epoch += 1
        order = self._epoch_order(epoch)
        n_batches = len(self)
        first, self._skip = self._skip, 0
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            # Keep `prefetch` batches of futures in flight, in order.
            pending = []
            submitted = first

            def submit_batch(b):
                lo = b * self.batch_size
                idxs = order[lo:lo + self.batch_size]
                # The final batch may be short (drop_last=False); the
                # local rows clamp to it.
                rows = (range(len(idxs)) if self.local_rows is None
                        else range(*self.local_rows.indices(len(idxs))))
                return [pool.submit(self._load, idxs[k], epoch, lo + k)
                        for k in rows]

            while submitted < n_batches and len(pending) < self.prefetch:
                pending.append(submit_batch(submitted))
                submitted += 1
            while pending:
                futures = pending.pop(0)
                if submitted < n_batches:
                    pending.append(submit_batch(submitted))
                    submitted += 1
                yield collate([f.result() for f in futures],
                              return_paths=self.return_paths)
        finally:
            # No blocking join: an abandoned iterator (early break, interpreter
            # exit) must not hang or raise during generator finalization —
            # at interpreter teardown even module globals may be gone.
            try:
                pool.shutdown(wait=False, cancel_futures=True)
            except Exception:
                pass


def fetch_dataloader(train_cfg, root: Optional[str] = None,
                     local_rows: Optional[slice] = None) -> StereoLoader:
    """Build the training-mix loader (reference ``fetch_dataloader``).

    ``local_rows``: with several processes, the global-batch rows this
    process trains on (``parallel.mesh.local_batch_rows``); only those
    samples are decoded here."""
    dataset = fetch_dataset(train_cfg, root=root)
    num_workers = getattr(train_cfg, "num_workers", None)
    if num_workers is None:
        raw = os.environ.get("SLURM_CPUS_PER_TASK", "6")
        try:
            cpus = int(raw)
        except ValueError:
            raise ValueError(
                f"SLURM_CPUS_PER_TASK must be an integer, got {raw!r} — "
                "fix the allocation or pass num_workers explicitly"
            ) from None
        # A 1-2 CPU allocation must still get ONE worker, not 0/-1
        # (StereoLoader clamps too, but clamp at the read so the derived
        # value is never nonsensical in logs/configs).
        num_workers = max(1, cpus - 2)
    return StereoLoader(dataset, batch_size=train_cfg.batch_size, shuffle=True,
                        num_workers=num_workers, drop_last=True,
                        seed=getattr(train_cfg, "seed", 0),
                        local_rows=local_rows,
                        retries=getattr(train_cfg, "data_retries", 2),
                        retry_backoff=getattr(train_cfg, "data_retry_backoff",
                                              0.05))


def device_prefetch(loader, device=None, size: int = 2, image_dtype=None):
    """Batches of the loader as tensors on ``device`` (the CPU when None),
    ``size`` in flight: each host batch is converted on a background thread
    to pinned tensors and copied ``non_blocking`` on a side CUDA stream, and
    the consumer's stream waits on the copy's event before it reads the
    batch (``record_stream`` keeps the memory for that stream).
    ``image_dtype`` (``torch.bfloat16`` under mixed precision) casts the
    images on the host before the copy, halving its bytes; the model's
    first operation casts them to the compute dtype anyway."""
    dev = torch.device("cpu" if device is None else device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None

    def put(b):
        out = {}
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if image_dtype is not None and k in ("image1", "image2"):
                    t = t.to(image_dtype)
                if cuda:
                    t = t.pin_memory()
                    with torch.cuda.stream(side):
                        t = t.to(dev, non_blocking=True)
                v = t
            out[k] = v
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def ready(item):
        out, event = item.result()
        if event is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(event)
            for t in out.values():
                if isinstance(t, torch.Tensor):
                    t.record_stream(cur)
        return out

    buf = []
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        for batch in loader:
            buf.append(ex.submit(put, batch))
            if len(buf) >= size:
                yield ready(buf.pop(0))
        while buf:
            yield ready(buf.pop(0))
    finally:
        # No blocking join: a training loop abandons this generator at
        # num_steps or a preemption, and waiting on a copy nobody will use
        # would only delay it.
        try:
            ex.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
