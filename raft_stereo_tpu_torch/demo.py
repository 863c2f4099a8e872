"""Demo CLI of the port: ``python -m raft_stereo_tpu_torch.demo``.

The flags of the root ``demo.py`` (reference ``demo.py:53-75``) plus
``--device``: glob left and right images, run the test-mode forward on each
pair, save the disparity as a jet-colormap PNG and optionally the raw
negative-disparity field as ``.npy``. Runs on CUDA unless ``--device cpu``.

``--video`` treats the sorted glob as ONE ordered video: an
``InferenceSession`` with ``--segments`` (CUDA graphs on the card) and a
``StreamRunner`` (``serve/stream.py``), so each frame's 1/8-res disparity
warm-starts the next through ``prepare_warm`` and a warm frame exits at the
first segment boundary where its delta-flow norm falls below
``--converge_tol``; each frame's iterations and quality label are printed.
The first frame has no seed and runs the cold composition to
``--valid_iters``: bit for bit the single-pair output.
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np
import torch

from raft_stereo_tpu_torch.config import (
    RAFTStereoConfig, add_model_args, resolve_device, with_eval_precision)
from raft_stereo_tpu_torch.data.frame_utils import read_image_rgb
from raft_stereo_tpu_torch.models import RAFTStereo, raft_stereo_forward
from raft_stereo_tpu_torch.obs.tracing import stage
from raft_stereo_tpu_torch.ops.padder import InputPadder


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--restore_ckpt', required=True,
                        help="restore checkpoint (.pth reference weights or a .pt "
                        "training bundle)")
    parser.add_argument('--save_numpy', action='store_true',
                        help='save output as numpy arrays')
    parser.add_argument('-l', '--left_imgs', help="path to all first (left) frames",
                        default="datasets/Middlebury/MiddEval3/testH/*/im0.png")
    parser.add_argument('-r', '--right_imgs', help="path to all second (right) frames",
                        default="datasets/Middlebury/MiddEval3/testH/*/im1.png")
    parser.add_argument('--output_directory', help="directory to save output",
                        default="demo_output")
    parser.add_argument('--valid_iters', type=int, default=32,
                        help='number of flow-field updates during forward pass')
    parser.add_argument('--video', action='store_true',
                        help="treat the sorted glob as ONE ordered video run through a "
                        "stream session: each frame's 1/8-res disparity warm-starts "
                        "the next (prepare_warm), and warm frames exit early when the "
                        "per-segment delta-flow norm falls below --converge_tol; "
                        "per-frame iterations and quality labels are printed. The "
                        "first frame is bit for bit the single-pair output")
    parser.add_argument('--segments', type=int, default=4,
                        help="video mode: segments the refinement splits into (must "
                        "divide valid_iters); convergence is checked at segment "
                        "boundaries. Ignored without --video")
    parser.add_argument('--converge_tol', type=float, default=None,
                        help="video mode: convergence tolerance (px/iter "
                        "segment-mean |delta_x| at 1/8 res); default "
                        "RAFT_CONVERGE_TOL else 0.01; 0 disables the early exit")
    parser.add_argument('--bucket', type=int, default=32,
                        help="pad shapes to multiples of this (a multiple of 32)")
    parser.add_argument('--device', default="cuda",
                        help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain torch versions)")
    add_model_args(parser)
    return parser


def infer_pair(model: RAFTStereo, image1, image2, *, iters: int = 32,
               bucket: int = 32) -> torch.Tensor:
    """Positive disparity (H, W) fp32 for one pair of (1, H, W, 3) images
    in [0, 255], on the model's device. The pair is edge-padded to a
    multiple of ``bucket`` and the result cropped back (the profiler
    ranges ``raft.pad`` and ``raft.unpad``, around the forward's own)."""
    dev = next(model.parameters()).device
    image1 = torch.as_tensor(image1, dtype=torch.float32, device=dev)
    image2 = torch.as_tensor(image2, dtype=torch.float32, device=dev)
    padder = InputPadder(image1.shape, divis_by=32, bucket=bucket)
    with stage("pad"):
        image1, image2 = padder.pad(image1, image2)
    _, flow_up = raft_stereo_forward(model, image1, image2, iters=iters)
    with stage("unpad"):
        return -padder.unpad(flow_up)[0, ..., 0]


def disparities(args):
    """The demo's frames: ``(left image path, positive disparity (H, W)
    fp32 numpy, quality label)`` for each pair of the sorted globs, the
    single-pair forward or, with ``--video``, the stream (the label is
    ``full``, ``converged:k`` or ``reduced_iters:k``)."""
    if args.video and args.valid_iters % args.segments:
        raise SystemExit(f"--segments {args.segments} must divide --valid_iters "
                         f"{args.valid_iters}")
    from raft_stereo_tpu_torch.engine.checkpoint import load_params

    cfg = with_eval_precision(RAFTStereoConfig.from_namespace(args))
    device = resolve_device(args.device)
    model = RAFTStereo(cfg)
    load_params(args.restore_ckpt, model)
    model = model.to(device).eval()
    runner = None
    if args.video:
        from raft_stereo_tpu_torch.serve import InferenceSession, SessionConfig, StreamRunner
        session = InferenceSession(model, cfg, SessionConfig(
            valid_iters=args.valid_iters, bucket=args.bucket, segments=args.segments,
            canary=False), device=device)
        runner = StreamRunner(session, converge_tol=args.converge_tol)
    left_images = sorted(glob.glob(args.left_imgs, recursive=True))
    right_images = sorted(glob.glob(args.right_imgs, recursive=True))
    print(f"Found {len(left_images)} images. Saving files to {args.output_directory}/")
    for imfile1, imfile2 in zip(left_images, right_images):
        image1 = read_image_rgb(imfile1).astype(np.float32)[None]
        image2 = read_image_rgb(imfile2).astype(np.float32)[None]
        if runner is not None:
            result = runner.infer(image1, image2)
            print(f"frame {runner.frames - 1}: {imfile1} iters={result.iters} "
                  f"quality={result.quality}")
            yield imfile1, result.disparity, result.quality
        else:
            yield imfile1, infer_pair(model, image1, image2, iters=args.valid_iters,
                                      bucket=args.bucket).cpu().numpy(), "full"


def demo(args) -> None:
    from matplotlib import pyplot as plt

    output_directory = Path(args.output_directory)
    output_directory.mkdir(exist_ok=True)
    for imfile1, disparity, _ in disparities(args):
        file_stem = imfile1.split('/')[-2]
        if args.save_numpy:
            np.save(output_directory / f"{file_stem}.npy", -disparity)
        plt.imsave(output_directory / f"{file_stem}.png", disparity, cmap='jet')


def main(argv=None) -> None:
    demo(build_parser().parse_args(argv))


if __name__ == '__main__':
    main()
