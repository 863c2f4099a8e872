"""Training CLI of the port: ``python -m raft_stereo_tpu_torch.train_stereo``.

The flags of the repository's ``train_stereo.py`` (the reference's, plus its
extensions), and ``--device`` (CUDA unless ``--device cpu``). It trains on
one card: more than one visible card, ``--spatial_shard`` > 1 or
``COORDINATOR_ADDRESS`` raise before the model is built (the next slice).
Checkpoints go to ``checkpoints/`` (or the directory ``--restore_ckpt``
names), logs to ``runs/``, both under the working directory.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    from raft_stereo_tpu_torch.config import add_model_args

    parser = argparse.ArgumentParser()
    parser.add_argument('--name', default='raft-stereo',
                        help="name your experiment")
    parser.add_argument('--restore_ckpt', help="restore checkpoint "
                        "(.pth loads reference weights; a .pt bundle "
                        "restores the full state, optimizer and step; a "
                        "DIRECTORY auto-resumes from its newest valid "
                        "bundle, skipping truncated/corrupt ones)")

    # Training parameters
    parser.add_argument('--batch_size', type=int, default=6,
                        help="batch size used during training.")
    parser.add_argument('--train_datasets', nargs='+', default=['sceneflow'],
                        help="training datasets.")
    parser.add_argument('--lr', type=float, default=0.0002,
                        help="max learning rate.")
    parser.add_argument('--num_steps', type=int, default=100000,
                        help="length of training schedule.")
    parser.add_argument('--image_size', type=int, nargs='+',
                        default=[320, 720],
                        help="size of the random image crops used during training.")
    parser.add_argument('--train_iters', type=int, default=16,
                        help="number of updates to the disparity field in each forward pass.")
    parser.add_argument('--wdecay', type=float, default=.00001,
                        help="Weight decay in optimizer.")

    # Validation parameters
    parser.add_argument('--valid_iters', type=int, default=32,
                        help='number of flow-field updates during validation forward pass')

    # Architecture choices (shared flag set, incl. reg_cuda/alt_cuda)
    add_model_args(parser)

    # Data augmentation
    parser.add_argument('--img_gamma', type=float, nargs='+', default=None,
                        help="gamma range")
    parser.add_argument('--saturation_range', type=float, nargs='+',
                        default=None, help='color saturation')
    parser.add_argument('--do_flip', default=False, choices=['h', 'v'],
                        help='flip the images horizontally or vertically')
    parser.add_argument('--spatial_scale', type=float, nargs='+',
                        default=[0, 0], help='re-scale the images randomly')
    parser.add_argument('--noyjitter', action='store_true',
                        help="don't simulate imperfect rectification")

    # Extensions of the JAX package's CLI
    parser.add_argument('--dataset_root', default=None,
                        help="root directory holding the datasets/ tree")
    parser.add_argument('--num_workers', type=int, default=None,
                        help="loader worker threads (default: SLURM sizing)")
    parser.add_argument('--seed', type=int, default=1234)
    parser.add_argument('--trace_dir', default=None,
                        help="profile one steady-state train step into this "
                             "directory (torch.profiler trace)")
    parser.add_argument('--spatial_shard', type=int, default=1,
                        help="shard each sample's height over this many "
                             "cards (not in this package yet: > 1 raises)")
    parser.add_argument('--fused_train', action='store_true',
                        help="engage the refinement loop's GRU and motion "
                             "kernels in the train step (bf16; their "
                             "backward is plain torch)")

    # Fault tolerance
    parser.add_argument('--max_bad_steps', type=int, default=5,
                        help="skip non-finite steps (params/opt_state "
                             "untouched) and abort only after this many "
                             "CONSECUTIVE bad steps; 0 = abort on first")
    parser.add_argument('--keep_ckpts', type=int, default=3,
                        help="keep-last-K retention over periodic "
                             "checkpoints (preempt/epoch/final bundles are "
                             "never pruned); 0 keeps all")
    parser.add_argument('--data_retries', type=int, default=2,
                        help="per-sample IO/decode retries before the "
                             "sample is quarantined and deterministically "
                             "substituted")
    parser.add_argument('--data_retry_backoff', type=float, default=0.05,
                        help="base seconds of the loader's exponential "
                             "per-sample retry backoff")
    parser.add_argument('--device', default=None,
                        help="torch device (default: cuda; pass cpu to run on the CPU)")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format='%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s')
    from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.engine.train import train

    cfg = RAFTStereoConfig.from_namespace(args)
    tcfg = TrainConfig.from_namespace(args)
    train(cfg, tcfg, data_root=args.dataset_root, device=args.device)


if __name__ == '__main__':
    main()
