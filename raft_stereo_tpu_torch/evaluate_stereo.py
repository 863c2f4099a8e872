"""Evaluation CLI of the port: ``python -m raft_stereo_tpu_torch.evaluate_stereo``.

The flags of the repository's ``evaluate_stereo.py`` and ``--device`` (CUDA
unless ``--device cpu``). bf16 follows the inference policy
(``config.eval_mixed_precision``): on when asked for, or with a kernel-backed
correlation. ``--spatial_shard`` > 1 needs several cards and raises (the
next slice).
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    from raft_stereo_tpu_torch.config import add_model_args

    parser = argparse.ArgumentParser()
    parser.add_argument('--restore_ckpt', help="restore checkpoint "
                        "(.pth reference weights or a .pt bundle)", default=None)
    parser.add_argument('--dataset', help="dataset for evaluation", required=True,
                        choices=["eth3d", "kitti", "things"]
                        + [f"middlebury_{s}" for s in 'FHQ'])
    parser.add_argument('--valid_iters', type=int, default=32,
                        help='number of flow-field updates during forward pass')
    add_model_args(parser)
    parser.add_argument('--dataset_root', default=None,
                        help="root directory holding the datasets/ tree")
    parser.add_argument('--bucket', type=int, default=None,
                        help="pad eval shapes up to multiples of this size "
                        "(must be a multiple of 32)")
    parser.add_argument('--segments', type=int, default=1,
                        help="run the refinement loop as this many chained "
                        "segments (must divide valid_iters)")
    parser.add_argument('--spatial_shard', type=int, default=1,
                        help="shard image height over this many cards (not in "
                        "this package yet: > 1 raises)")
    parser.add_argument('--device', default=None,
                        help="torch device (default: cuda; pass cpu to run on the CPU)")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format='%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s')
    from raft_stereo_tpu_torch.config import RAFTStereoConfig, eval_mixed_precision
    from raft_stereo_tpu_torch.engine import evaluate as ev
    from raft_stereo_tpu_torch.engine.checkpoint import load_params
    from raft_stereo_tpu_torch.engine.train import NEXT_SLICE
    from raft_stereo_tpu_torch.models import init_raft_stereo

    if args.spatial_shard > 1:
        raise SystemExit(f"--spatial_shard {args.spatial_shard}: {NEXT_SLICE}")
    if args.segments != 1 and args.valid_iters % args.segments:
        raise SystemExit("--segments must divide --valid_iters")
    cfg = RAFTStereoConfig.from_namespace(args)
    model = init_raft_stereo(cfg, device=args.device)
    if args.restore_ckpt is not None:
        logging.info("Loading checkpoint...")
        load_params(args.restore_ckpt, model)
        logging.info("Done loading checkpoint")
    print(f"The model has {ev.count_parameters(model) / 1e6:.2f}M learnable parameters.")
    common = dict(iters=args.valid_iters, mixed_prec=eval_mixed_precision(cfg),
                  root=args.dataset_root, segments=args.segments, bucket=args.bucket)
    if args.dataset == 'eth3d':
        ev.validate_eth3d(model, cfg, **common)
    elif args.dataset == 'kitti':
        ev.validate_kitti(model, cfg, **common)
    elif args.dataset.startswith('middlebury_'):
        ev.validate_middlebury(model, cfg, split=args.dataset[-1], **common)
    elif args.dataset == 'things':
        ev.validate_things(model, cfg, **common)


if __name__ == '__main__':
    main()
