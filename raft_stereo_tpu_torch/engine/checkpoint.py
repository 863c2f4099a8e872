"""Full-state checkpoints: the model, the optimizer and the step in one
bundle (the JAX package's ``engine/checkpoint.py`` API and file grammar).

A bundle is ``MAGIC + sha256(payload) + payload``, written to a temporary
file and renamed, so a save cut short never replaces a good bundle and a
copy truncated later fails its hash. The payload is the port's own: a
``torch.save`` of ``{"model": state_dict, "optimizer":
TrainOptimizer.state_dict(), "step": int}`` (tensors on the CPU), loadable
with ``weights_only=True``, under the suffix ``.pt`` (the JAX package's
bundles are ``.msgpack`` and carry a flax payload; neither package reads
the other's). A file without the magic loads as a legacy bundle, unchecked.

Names: ``{step}_{name}.pt`` (periodic), ``{step}_preempt_{name}.pt``,
``{step}_epoch_{name}.pt`` and the final ``{name}.pt``.
:func:`find_latest_checkpoint` walks the numbered ones newest first and
skips the invalid; :func:`prune_checkpoints` keeps the last K valid
periodic ones. ``.pth`` files (the reference's weights) load through
``transplant.load_pth``.

With several processes only the lead (rank 0) writes: every rank holds the
same state, and two writers of one file would corrupt it, so a save from
any other rank raises.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import re
from typing import Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

CKPT_SUFFIX = ".pt"

_MAGIC = b"RSCKPT1\n"
_DIGEST_LEN = hashlib.sha256().digest_size
_HEADER_LEN = len(_MAGIC) + _DIGEST_LEN

_STEP_RE = re.compile(r"^(\d+)_(?:preempt_|epoch_)?(.+)$")


class CheckpointError(ValueError):
    """A checkpoint file failed integrity validation (truncated/corrupt)."""


def check_run_name(name: str) -> str:
    """Reject run names that collide with the bundle-filename grammar: a
    name starting with ``<digits>_``, ``preempt_`` or ``epoch_`` would make
    one run's bundles parse as another's, and pruning or resuming would
    then touch the other run's files."""
    if re.match(r"^\d+_", name) or name.startswith(("preempt_", "epoch_")):
        raise ValueError(
            f"run name {name!r} collides with the checkpoint filename "
            f"grammar ('<step>_[preempt_|epoch_]<name>{CKPT_SUFFIX}'); it must "
            "not start with digits-underscore, 'preempt_' or 'epoch_'")
    return name


def check_lead(what: str) -> None:
    """Raise unless this process may write: no process group joined, or
    rank 0 of it."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        raise RuntimeError(f"rank {dist.get_rank()} may not write {what}: only the lead "
                           "(rank 0) writes")


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def bundle_state(model, optimizer=None, step: int = 0) -> Dict:
    """What a bundle holds, as host tensors: ``{"model", "optimizer",
    "step"}`` (arguments as :func:`save_checkpoint` takes them)."""
    model_state = model.state_dict() if hasattr(model, "state_dict") else model
    opt_state = optimizer.state_dict() if hasattr(optimizer, "state_dict") else optimizer
    return {"model": _cpu(dict(model_state)), "optimizer": _cpu(opt_state), "step": int(step)}


def load_state(state: Dict, model=None, optimizer=None) -> int:
    """Load a bundle's state into ``model`` (strictly) and ``optimizer``
    where given; returns its step."""
    if model is not None:
        model.load_state_dict(state["model"], strict=True)
    if optimizer is not None and state.get("optimizer") is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def save_checkpoint(path: str, model, optimizer=None, step: int = 0) -> str:
    """Write ``(model, optimizer, step)`` atomically; returns the path.
    ``model`` is a module or a state dict, ``optimizer`` a
    :class:`~.optimizer.TrainOptimizer`, its state dict, or None. Raises on
    a rank other than the lead of a joined process group."""
    check_lead("a checkpoint")
    buf = io.BytesIO()
    torch.save(bundle_state(model, optimizer, step), buf)
    blob = buf.getvalue()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(hashlib.sha256(blob).digest())
        f.write(blob)
    os.replace(tmp, path)
    return path


def _read_payload(path: str) -> Tuple[bytes, bool]:
    """The payload and whether its hash was verified; raises
    :class:`CheckpointError` on a truncated header or a digest mismatch."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_MAGIC):
        return blob, False
    if len(blob) < _HEADER_LEN:
        raise CheckpointError(f"{path}: truncated checkpoint header")
    payload = blob[_HEADER_LEN:]
    if hashlib.sha256(payload).digest() != blob[len(_MAGIC):_HEADER_LEN]:
        raise CheckpointError(f"{path}: checkpoint content hash mismatch (truncated or "
                              "corrupt bundle)")
    return payload, True


def _parse(payload: bytes, path: str) -> Dict:
    try:
        state = torch.load(io.BytesIO(payload), map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 - any unpickling failure: not a bundle
        raise CheckpointError(f"{path}: not a checkpoint bundle ({e})") from e
    if not isinstance(state, dict) or "model" not in state or "step" not in state:
        raise CheckpointError(f"{path}: not a checkpoint bundle")
    return state


def bundle_step(path: str) -> int:
    """A bundle's step: from the filename for numbered bundles, else from
    the payload (verifying the hash frame)."""
    stem = os.path.basename(path)
    if stem.endswith(CKPT_SUFFIX):
        stem = stem[:-len(CKPT_SUFFIX)]
    m = _STEP_RE.match(stem)
    if m is not None:
        return int(m.group(1))
    return int(_parse(_read_payload(path)[0], path)["step"])


def validate_checkpoint(path: str) -> bool:
    """True iff ``path`` holds a sound bundle: its hash holds, or, for a
    legacy file without one, its payload loads."""
    try:
        payload, verified = _read_payload(path)
        if not verified:
            _parse(payload, path)
        return True
    except Exception:  # noqa: BLE001 - any failure means "not loadable"
        return False


def load_checkpoint(path: str, model=None, optimizer=None) -> Tuple[Dict, Optional[Dict], int]:
    """Read a bundle: ``(model_state, optimizer_state, step)``. With
    ``model`` and ``optimizer`` given, their states are loaded into them
    too (the model strictly)."""
    state = _parse(_read_payload(path)[0], path)
    step = load_state(state, model, optimizer)
    return state["model"], state.get("optimizer"), step


def load_params(path: str, model) -> None:
    """Load weights into ``model`` from a bundle or a reference ``.pth``."""
    if path.endswith(".pth"):
        from raft_stereo_tpu_torch.transplant import load_pth
        load_pth(model, path)
    else:
        load_checkpoint(path, model)


def _numbered_bundles(ckpt_dir: str, name: Optional[str] = None) -> List[Tuple[int, str]]:
    pat = _STEP_RE if name is None else re.compile(
        rf"^(\d+)_(?:preempt_|epoch_)?({re.escape(name)})$")
    out = []
    for fname in os.listdir(ckpt_dir):
        if not fname.endswith(CKPT_SUFFIX):
            continue
        m = pat.match(fname[:-len(CKPT_SUFFIX)])
        if m is not None:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, fname)))
    return out


def find_latest_checkpoint(ckpt_dir: str, name: Optional[str] = None,
                           include_final: bool = False) -> Optional[str]:
    """The newest valid bundle in ``ckpt_dir``, or None: numbered bundles
    newest first, an invalid one logged and skipped. ``include_final``
    (with ``name``) also weighs the final ``{name}`` bundle, which wins
    when its step is at least the newest valid numbered one's."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for step, path in sorted(_numbered_bundles(ckpt_dir, name), reverse=True):
        if validate_checkpoint(path):
            best = (step, path)
            break
        logger.warning("skipping invalid checkpoint %s (truncated/corrupt); "
                       "falling back to the previous bundle", path)
    if include_final and name is not None:
        final = os.path.join(ckpt_dir, name + CKPT_SUFFIX)
        if os.path.exists(final):
            try:
                fstep = bundle_step(final)
            except Exception:  # noqa: BLE001 - corrupt final: not a candidate
                logger.warning("ignoring corrupt final bundle %s", final)
            else:
                if best is None or fstep >= best[0]:
                    return final
    return best[1] if best is not None else None


def prune_checkpoints(ckpt_dir: str, name: str, keep: int) -> List[str]:
    """Keep the last ``keep`` valid periodic ``{step}_{name}`` bundles and
    remove older ones; preempt, epoch and final bundles are never pruned,
    and a corrupt bundle inside the window is left in place. Returns the
    removed paths."""
    if keep <= 0 or not os.path.isdir(ckpt_dir):
        return []
    periodic = re.compile(rf"^(\d+)_{re.escape(name)}{re.escape(CKPT_SUFFIX)}$")
    numbered = []
    for fname in os.listdir(ckpt_dir):
        m = periodic.match(fname)
        if m is not None:
            numbered.append((int(m.group(1)), os.path.join(ckpt_dir, fname)))
    removed = []
    kept_valid = 0
    for _, path in sorted(numbered, reverse=True):
        if kept_valid < keep:
            if validate_checkpoint(path):
                kept_valid += 1
            continue
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    return removed
