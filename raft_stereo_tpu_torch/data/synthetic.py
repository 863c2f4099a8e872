"""A synthetic FlyingThings3D tree for runs without the dataset.

:func:`write_things_tree` writes the SceneFlow layout that
``datasets.SceneFlowDatasets`` reads (``FlyingThings3D/frames_cleanpass``
and ``frames_finalpass`` PNG pairs, ``disparity`` PFM maps, ``TRAIN`` and
``TEST`` splits), from a seed: the left image is seeded texture, the
disparity a smooth seeded field in ``[0, max_disp]`` px, and the right image
the left one sampled at ``x + d`` (so that left pixel x matches right pixel
``x - d``, as in the dataset). Both passes hold the same images.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from raft_stereo_tpu_torch.data.frame_utils import write_pfm


def _smooth(rng: np.random.Generator, h: int, w: int, cells: int) -> np.ndarray:
    """A smooth field in [0, 1]: bilinear upsampling of a coarse random grid."""
    gh, gw = max(2, h // cells), max(2, w // cells)
    grid = rng.uniform(0.0, 1.0, (gh, gw))
    ys = np.linspace(0, gh - 1, h)
    xs = np.linspace(0, gw - 1, w)
    y0 = np.minimum(ys.astype(int), gh - 2)
    x0 = np.minimum(xs.astype(int), gw - 2)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    g00, g01 = grid[y0][:, x0], grid[y0][:, x0 + 1]
    g10, g11 = grid[y0 + 1][:, x0], grid[y0 + 1][:, x0 + 1]
    return ((1 - fy) * ((1 - fx) * g00 + fx * g01) + fy * ((1 - fx) * g10 + fx * g11))


def synthetic_pair(rng: np.random.Generator, h: int, w: int, max_disp: float):
    """``(left uint8 (H, W, 3), right uint8, disparity float32 (H, W))``."""
    texture = np.stack([_smooth(rng, h, w, c) for c in (8, 24, 64)], axis=-1)
    left = 255.0 * (0.55 * texture + 0.45 * rng.uniform(0.0, 1.0, (h, w, 3)))
    disp = (max_disp * _smooth(rng, h, w, 96)).astype(np.float32)
    src = np.clip(np.arange(w)[None, :] + disp, 0, w - 1)
    x0 = np.minimum(np.floor(src).astype(np.int64), w - 2)
    frac = (src - x0)[..., None]
    rows = np.arange(h)[:, None]
    right = left[rows, x0] * (1 - frac) + left[rows, x0 + 1] * frac
    return (np.clip(np.rint(left), 0, 255).astype(np.uint8),
            np.clip(np.rint(right), 0, 255).astype(np.uint8), disp)


def write_things_tree(root: str, *, n_train: int = 16, n_test: int = 2, h: int = 540,
                      w: int = 960, max_disp: float = 64.0, seed: int = 0) -> str:
    """Write the tree under ``root`` and return ``root``."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    things = osp.join(root, "FlyingThings3D")
    for split, n in (("TRAIN", n_train), ("TEST", n_test)):
        for i in range(n):
            left, right, disp = synthetic_pair(rng, h, w, max_disp)
            name = f"{i:04d}.png"
            for dstype in ("frames_cleanpass", "frames_finalpass"):
                for side, img in (("left", left), ("right", right)):
                    d = osp.join(things, dstype, split, "A", "0000", side)
                    os.makedirs(d, exist_ok=True)
                    Image.fromarray(img).save(osp.join(d, name))
            d = osp.join(things, "disparity", split, "A", "0000", "left")
            os.makedirs(d, exist_ok=True)
            write_pfm(osp.join(d, name.replace(".png", ".pfm")), disp)
    return root
