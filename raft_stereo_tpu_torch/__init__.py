"""RAFT-Stereo in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``raft_stereo_tpu``, which stays the reference.
This package imports ``torch`` and never ``jax`` or ``raft_stereo_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper runs its plain torch version.

The names below load on first use (PEP 562), so that the stdlib-only
subpackages (``analysis``, its linter and graftlock) import without torch.
"""

import importlib

_EXPORTS = {
    "config": ("RAFTStereoConfig", "TrainConfig", "add_model_args", "eval_mixed_precision",
               "resolve_device", "with_eval_precision"),
    "models": ("RAFTStereo", "init_raft_stereo", "raft_stereo_epilogue", "raft_stereo_forward",
               "raft_stereo_inference", "raft_stereo_prepare", "raft_stereo_segment",
               "raft_stereo_segment_carry", "raft_stereo_train_forward"),
}
_ORIGIN = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_ORIGIN)


def __getattr__(name: str):
    mod = _ORIGIN.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
