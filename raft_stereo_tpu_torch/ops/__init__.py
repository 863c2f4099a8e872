"""Tensor operations of the port: plain torch ops with the reference's
semantics on NHWC tensors, plus the kernel wrappers in :mod:`.stream`,
:mod:`.resident` and :mod:`.encoder`."""

from raft_stereo_tpu_torch.ops.basic import (  # noqa: F401
    conv2d, frozen_batch_norm, group_norm, instance_norm)
from raft_stereo_tpu_torch.ops.chunked import map_chunked  # noqa: F401
from raft_stereo_tpu_torch.ops.coords import coords_grid, upflow  # noqa: F401
from raft_stereo_tpu_torch.ops.padder import InputPadder, bucket_shape  # noqa: F401
from raft_stereo_tpu_torch.ops.pooling import avg_pool_w2, pool2x, pool4x  # noqa: F401
from raft_stereo_tpu_torch.ops.resize import interp_align_corners  # noqa: F401
from raft_stereo_tpu_torch.ops.sampler import sample_1d_zeros, sample_rows_zeros  # noqa: F401
from raft_stereo_tpu_torch.ops.upsample import convex_upsample  # noqa: F401

__all__ = [
    "conv2d", "frozen_batch_norm", "group_norm", "instance_norm",
    "coords_grid", "upflow",
    "sample_1d_zeros", "sample_rows_zeros",
    "avg_pool_w2", "pool2x", "pool4x",
    "interp_align_corners",
    "convex_upsample",
    "InputPadder", "bucket_shape",
    "map_chunked",
]
