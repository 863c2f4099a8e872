"""RAFT-Stereo in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``raft_stereo_tpu``, which stays the reference.
This package imports ``torch`` and never ``jax`` or ``raft_stereo_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper runs its plain torch version.
"""

from raft_stereo_tpu_torch.config import (  # noqa: F401
    RAFTStereoConfig, TrainConfig, add_model_args, eval_mixed_precision, resolve_device,
    with_eval_precision)
from raft_stereo_tpu_torch.models import (  # noqa: F401
    RAFTStereo, init_raft_stereo, raft_stereo_epilogue, raft_stereo_forward,
    raft_stereo_inference, raft_stereo_prepare, raft_stereo_segment,
    raft_stereo_segment_carry, raft_stereo_train_forward)
