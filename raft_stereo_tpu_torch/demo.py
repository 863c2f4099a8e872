"""Demo CLI of the port: ``python -m raft_stereo_tpu_torch.demo``.

The flags of the root ``demo.py`` (reference ``demo.py:53-75``) plus
``--device``: glob left and right images, run the test-mode forward on each
pair, save the disparity as a jet-colormap PNG and optionally the raw
negative-disparity field as ``.npy``. Runs on CUDA unless ``--device cpu``.
Only the single-pair path is ported; ``--video`` waits for the serving
slice.
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np
import torch

from raft_stereo_tpu_torch.config import (
    RAFTStereoConfig, add_model_args, resolve_device, with_eval_precision)
from raft_stereo_tpu_torch.models import RAFTStereo, raft_stereo_forward
from raft_stereo_tpu_torch.ops.padder import InputPadder


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--restore_ckpt', help="restore checkpoint (.pth)", required=True)
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
                        help="video mode (not ported yet: the serving slice)")
    parser.add_argument('--segments', type=int, default=4,
                        help="video mode segments; ignored without --video")
    parser.add_argument('--converge_tol', type=float, default=None,
                        help="video mode convergence tolerance; ignored without --video")
    parser.add_argument('--bucket', type=int, default=32,
                        help="pad shapes to multiples of this (a multiple of 32)")
    parser.add_argument('--device', default="cuda",
                        help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain torch versions)")
    add_model_args(parser)
    return parser


def read_image_rgb(path) -> np.ndarray:
    """An image as (H, W, 3) uint8: grayscale tiled to 3 channels, alpha
    dropped."""
    from PIL import Image
    with Image.open(path) as im:
        img = np.asarray(im).astype(np.uint8)
    if img.ndim == 2:
        return np.tile(img[..., None], (1, 1, 3))
    return img[..., :3]


def infer_pair(model: RAFTStereo, image1, image2, *, iters: int = 32,
               bucket: int = 32) -> torch.Tensor:
    """Positive disparity (H, W) fp32 for one pair of (1, H, W, 3) images
    in [0, 255], on the model's device. The pair is edge-padded to a
    multiple of ``bucket`` and the result cropped back."""
    dev = next(model.parameters()).device
    image1 = torch.as_tensor(image1, dtype=torch.float32, device=dev)
    image2 = torch.as_tensor(image2, dtype=torch.float32, device=dev)
    padder = InputPadder(image1.shape, divis_by=32, bucket=bucket)
    image1, image2 = padder.pad(image1, image2)
    _, flow_up = raft_stereo_forward(model, image1, image2, iters=iters)
    return -padder.unpad(flow_up)[0, ..., 0]


def demo(args) -> None:
    if args.video:
        raise SystemExit("--video is not ported yet (ROADMAP: the serving slice)")
    from matplotlib import pyplot as plt

    from raft_stereo_tpu_torch.transplant import load_pth

    cfg = with_eval_precision(RAFTStereoConfig.from_namespace(args))
    device = resolve_device(args.device)
    model = RAFTStereo(cfg)
    load_pth(model, args.restore_ckpt)
    model = model.to(device).eval()

    output_directory = Path(args.output_directory)
    output_directory.mkdir(exist_ok=True)
    left_images = sorted(glob.glob(args.left_imgs, recursive=True))
    right_images = sorted(glob.glob(args.right_imgs, recursive=True))
    print(f"Found {len(left_images)} images. Saving files to {output_directory}/")
    for imfile1, imfile2 in zip(left_images, right_images):
        image1 = read_image_rgb(imfile1).astype(np.float32)[None]
        image2 = read_image_rgb(imfile2).astype(np.float32)[None]
        disparity = infer_pair(model, image1, image2, iters=args.valid_iters,
                               bucket=args.bucket).cpu().numpy()
        file_stem = imfile1.split('/')[-2]
        if args.save_numpy:
            np.save(output_directory / f"{file_stem}.npy", -disparity)
        plt.imsave(output_directory / f"{file_stem}.png", disparity, cmap='jet')


def main(argv=None) -> None:
    demo(build_parser().parse_args(argv))


if __name__ == '__main__':
    main()
