"""RAFT-Stereo model modules of the port."""

from raft_stereo_tpu_torch.models.raft_stereo import (  # noqa: F401
    FNET_SEQUENTIAL_MIN_PIXELS, RAFTStereo, init_raft_stereo, raft_stereo_epilogue,
    raft_stereo_forward, raft_stereo_inference, raft_stereo_prepare,
    raft_stereo_segment, raft_stereo_segment_carry, raft_stereo_train_forward,
    ShardedCarry, carry_rows, gather_rows, shard_rows, stack_refinement_states,
    take_refinement_rows)
