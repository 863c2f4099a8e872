"""Training and evaluation engines of the port (the JAX package's
``engine/``)."""

from raft_stereo_tpu_torch.engine.checkpoint import (  # noqa: F401
    CheckpointError, bundle_step, check_run_name, find_latest_checkpoint, load_checkpoint,
    load_params, prune_checkpoints, save_checkpoint, validate_checkpoint)
from raft_stereo_tpu_torch.engine.logger import Logger  # noqa: F401
from raft_stereo_tpu_torch.engine.loss import sequence_loss  # noqa: F401
from raft_stereo_tpu_torch.engine.optimizer import (  # noqa: F401
    TrainOptimizer, make_optimizer, onecycle_linear_schedule)
from raft_stereo_tpu_torch.engine.steps import make_eval_step, make_train_step  # noqa: F401
