"""Stereo datasets: base class, the 7 named datasets, and training-mix logic.

Reference ``core/stereo_datasets.py``. Samples are plain dicts of NHWC-ready
numpy arrays; RNG is explicit (a ``np.random.Generator`` per draw) instead of
the reference's per-worker global reseeding (:55-61).

Sample protocol (``__getitem__(index, rng)``):
- train: ``{"paths", "image1"(H,W,3)f32, "image2", "flow"(H,W,1)f32,
  "valid"(H,W)f32}`` — disparity is encoded as negative flow-x,
  ``flow = -disp`` (:77), so the network regresses along the epipolar line;
- test (``is_test``): ``{"paths", "image1", "image2", "extra_info"}``.

The KITTI constructor accepts ``split=`` as an alias for ``image_set=`` —
the reference's training-mix call ``KITTI(aug_params, split=...)`` (:298)
is a ``TypeError`` against its own constructor (:247); fixed here.

The port's copy of the JAX package's ``data/datasets.py``, on the port's
readers and augmentors.
"""

from __future__ import annotations

import copy
import logging
import os
import os.path as osp
import re
from glob import glob
from typing import Callable, List, Optional, Sequence

import numpy as np

from raft_stereo_tpu_torch.data import frame_utils
from raft_stereo_tpu_torch.data.augmentor import FlowAugmentor, SparseFlowAugmentor

logger = logging.getLogger(__name__)

MAX_DISP_DEFAULT = 512  # dense datasets: pixels with |disp| >= 512 are invalid


def _make_augmentor(aug_params: Optional[dict], sparse: bool):
    if aug_params is None or "crop_size" not in aug_params:
        return None
    cls = SparseFlowAugmentor if sparse else FlowAugmentor
    return cls(**aug_params)


class StereoDataset:
    """Base dataset: a list of (image1, image2, disparity) path records."""

    def __init__(self, aug_params: Optional[dict] = None, sparse: bool = False,
                 reader: Optional[Callable] = None):
        aug_params = dict(aug_params) if aug_params is not None else None
        self.img_pad = aug_params.pop("img_pad", None) if aug_params else None
        self.augmentor = _make_augmentor(aug_params, sparse)
        self.sparse = sparse
        self.disparity_reader = reader or frame_utils.read_gen
        self.is_test = False
        self.image_list: List[List[str]] = []
        self.disparity_list: List[str] = []
        self.extra_info: List = []

    # -- record loading ---------------------------------------------------

    def _read_disparity(self, path):
        disp = self.disparity_reader(path)
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < MAX_DISP_DEFAULT
        return np.asarray(disp, np.float32), np.asarray(valid)

    def __getitem__(self, index, rng: Optional[np.random.Generator] = None):
        if self.is_test:
            img1 = frame_utils.read_image_rgb(self.image_list[index][0])
            img2 = frame_utils.read_image_rgb(self.image_list[index][1])
            return {"paths": tuple(self.image_list[index]),
                    "image1": img1.astype(np.float32),
                    "image2": img2.astype(np.float32),
                    "extra_info": self.extra_info[index]}

        if rng is None:
            rng = np.random.default_rng()
        index = index % len(self.image_list)
        disp, valid = self._read_disparity(self.disparity_list[index])
        img1 = frame_utils.read_image_rgb(self.image_list[index][0])
        img2 = frame_utils.read_image_rgb(self.image_list[index][1])
        # Disparity as negative flow-x: right-image matches sit to the left.
        flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(
                    img1, img2, flow, valid, rng)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, rng)

        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        flow = flow.astype(np.float32)
        if self.sparse:
            valid_out = valid.astype(np.float32)
        else:
            valid_out = ((np.abs(flow[..., 0]) < MAX_DISP_DEFAULT)
                         & (np.abs(flow[..., 1]) < MAX_DISP_DEFAULT)
                         ).astype(np.float32)

        if self.img_pad is not None:
            pad_h, pad_w = self.img_pad
            pad = ((pad_h, pad_h), (pad_w, pad_w), (0, 0))
            img1 = np.pad(img1, pad)
            img2 = np.pad(img2, pad)

        return {
            "paths": tuple(self.image_list[index]) + (self.disparity_list[index],),
            "image1": img1,
            "image2": img2,
            "flow": flow[..., :1],  # only x (disparity) is supervised
            "valid": valid_out,
        }

    # -- mixing operators (reference :111-120) ----------------------------

    def __mul__(self, v: int) -> "StereoDataset":
        out = copy.deepcopy(self)
        out.image_list = v * self.image_list
        out.disparity_list = v * self.disparity_list
        out.extra_info = v * self.extra_info
        return out

    def __add__(self, other) -> "ConcatStereoDataset":
        # Each part keeps its own reader/sparse-flag/augmentor — merging path
        # lists (the reference-style shortcut) would decode every dataset with
        # the first one's reader. Concat dispatches per index instead (what
        # torch's ConcatDataset does for the reference).
        return ConcatStereoDataset([self, other])

    def __len__(self) -> int:
        return len(self.image_list)

    def _add_pairs(self, image1_list, image2_list, disp_list):
        for img1, img2, disp in zip(image1_list, image2_list, disp_list):
            self.image_list.append([img1, img2])
            self.disparity_list.append(disp)


class ConcatStereoDataset:
    """Concatenation of stereo datasets, dispatching each index to the part
    that owns it (so mixed sparse/dense datasets keep their own readers and
    augmentors). Supports the same ``+`` / ``*`` mixing algebra."""

    def __init__(self, parts):
        self.parts = []
        for p in parts:
            self.parts.extend(p.parts if isinstance(p, ConcatStereoDataset)
                              else [p])
        self._cum = np.cumsum([len(p) for p in self.parts])

    def __len__(self) -> int:
        return int(self._cum[-1]) if len(self.parts) else 0

    def __getitem__(self, index, rng: Optional[np.random.Generator] = None):
        index = index % len(self)
        part = int(np.searchsorted(self._cum, index, side="right"))
        local = index - (int(self._cum[part - 1]) if part else 0)
        return self.parts[part].__getitem__(local, rng=rng)

    def __add__(self, other) -> "ConcatStereoDataset":
        return ConcatStereoDataset([self, other])

    def __mul__(self, v: int) -> "ConcatStereoDataset":
        return ConcatStereoDataset(self.parts * v)


class SceneFlowDatasets(StereoDataset):
    """FlyingThings3D + Monkaa + Driving (reference :123-184). The TEST split
    keeps the fixed seed-1000 400-image validation subset."""

    def __init__(self, aug_params=None, root="datasets",
                 dstype="frames_cleanpass", things_test: bool = False):
        super().__init__(aug_params)
        self.root = root
        self.dstype = dstype
        if things_test:
            self._add_things("TEST")
        else:
            self._add_things("TRAIN")
            self._add_monkaa()
            self._add_driving()

    def _glob_pairs(self, left_pattern: str):
        lefts = sorted(glob(left_pattern))
        rights = [p.replace("left", "right") for p in lefts]
        disps = [p.replace(self.dstype, "disparity").replace(".png", ".pfm")
                 for p in lefts]
        return lefts, rights, disps

    def _add_things(self, split: str = "TRAIN"):
        before = len(self.disparity_list)
        root = osp.join(self.root, "FlyingThings3D")
        lefts, rights, disps = self._glob_pairs(
            osp.join(root, self.dstype, split, "*/*/left/*.png"))
        # Fixed validation subset: seed-1000 permutation, first 400 indices
        # (reference :145-152) — reproduced with a local Generator rather than
        # by touching global numpy state.
        val_idxs = set(
            np.random.RandomState(1000).permutation(len(lefts))[:400])
        for idx in range(len(lefts)):
            if split == "TRAIN" or idx in val_idxs:
                self._add_pairs([lefts[idx]], [rights[idx]], [disps[idx]])
        logger.info("Added %d from FlyingThings %s",
                    len(self.disparity_list) - before, self.dstype)

    def _add_monkaa(self):
        before = len(self.disparity_list)
        self._add_pairs(*self._glob_pairs(
            osp.join(self.root, "Monkaa", self.dstype, "*/left/*.png")))
        logger.info("Added %d from Monkaa %s",
                    len(self.disparity_list) - before, self.dstype)

    def _add_driving(self):
        before = len(self.disparity_list)
        self._add_pairs(*self._glob_pairs(
            osp.join(self.root, "Driving", self.dstype, "*/*/*/left/*.png")))
        logger.info("Added %d from Driving %s",
                    len(self.disparity_list) - before, self.dstype)


class ETH3D(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/ETH3D",
                 split: str = "training"):
        super().__init__(aug_params, sparse=True)
        image1_list = sorted(glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        image2_list = sorted(glob(osp.join(root, f"two_view_{split}/*/im1.png")))
        if split == "training":
            disp_list = sorted(
                glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm")))
        else:  # test split has no GT; reference substitutes a fixed dummy path
            disp_list = [osp.join(root, "two_view_training_gt/playground_1l/"
                                  "disp0GT.pfm")] * len(image1_list)
        self._add_pairs(image1_list, image2_list, disp_list)


class SintelStereo(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/SintelStereo"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_sintel)
        image1_list = sorted(glob(osp.join(root, "training/*_left/*/frame_*.png")))
        image2_list = sorted(glob(osp.join(root, "training/*_right/*/frame_*.png")))
        # clean + final pass share one disparity directory (reference :205)
        disp_list = sorted(glob(
            osp.join(root, "training/disparities/*/frame_*.png"))) * 2
        for img1, img2, disp in zip(image1_list, image2_list, disp_list):
            if img1.split("/")[-2:] != disp.split("/")[-2:]:
                raise ValueError(f"misaligned Sintel pair: {img1} vs {disp}")
            self._add_pairs([img1], [img2], [disp])


class FallingThings(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/FallingThings"):
        super().__init__(aug_params, reader=frame_utils.read_disp_falling_things)
        if not os.path.exists(root):
            raise FileNotFoundError(root)
        with open(osp.join(root, "filenames.txt")) as f:
            filenames = sorted(f.read().splitlines())
        self._add_pairs(
            [osp.join(root, e) for e in filenames],
            [osp.join(root, e.replace("left.jpg", "right.jpg")) for e in filenames],
            [osp.join(root, e.replace("left.jpg", "left.depth.png"))
             for e in filenames])


class TartanAir(StereoDataset):
    def __init__(self, aug_params=None, root="datasets",
                 keywords: Sequence[str] = ()):
        super().__init__(aug_params, reader=frame_utils.read_disp_tartan_air)
        if not os.path.exists(root):
            raise FileNotFoundError(root)
        with open(osp.join(root, "tartanair_filenames.txt")) as f:
            filenames = sorted(
                s for s in f.read().splitlines()
                if "seasonsforest_winter/Easy" not in s)
        for kw in keywords:
            filenames = sorted(s for s in filenames if kw in s.lower())
        self._add_pairs(
            [osp.join(root, e) for e in filenames],
            [osp.join(root, e.replace("_left", "_right")) for e in filenames],
            [osp.join(root, e.replace("image_left", "depth_left")
                      .replace("left.png", "left_depth.npy"))
             for e in filenames])


class KITTI(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/KITTI",
                 image_set: str = "training", split: Optional[str] = None):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_kitti)
        if not os.path.exists(root):
            raise FileNotFoundError(root)
        # `split` aliases `image_set` (any value containing 'kitti' means
        # training) — fixes the reference's TypeError in the training mix.
        if split is not None:
            image_set = "training" if "kitti" in split else split
        image1_list = sorted(glob(osp.join(root, image_set, "image_2/*_10.png")))
        image2_list = sorted(glob(osp.join(root, image_set, "image_3/*_10.png")))
        if image_set == "training":
            disp_list = sorted(glob(osp.join(root, "training",
                                             "disp_occ_0/*_10.png")))
        else:  # test split: fixed dummy GT path (reference :253)
            disp_list = [osp.join(root, "training/disp_occ_0/000085_10.png")
                         ] * len(image1_list)
        self._add_pairs(image1_list, image2_list, disp_list)


class Middlebury(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/Middlebury",
                 split: str = "F"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_middlebury)
        if not os.path.exists(root):
            raise FileNotFoundError(root)
        if split not in ("F", "H", "Q"):
            raise ValueError(f"Middlebury split must be F/H/Q, got {split!r}")
        with open(osp.join(root, "MiddEval3/official_train.txt")) as f:
            official = set(f.read().splitlines())
        scenes = sorted(
            name for name in map(
                osp.basename, glob(osp.join(root, "MiddEval3/trainingF/*")))
            if name in official)
        base = osp.join(root, "MiddEval3", f"training{split}")
        if not scenes:
            raise FileNotFoundError(f"no official_train scenes under {base}")
        self._add_pairs(
            [osp.join(base, name, "im0.png") for name in scenes],
            [osp.join(base, name, "im1.png") for name in scenes],
            [osp.join(base, name, "disp0GT.pfm") for name in scenes])


# ---------------------------------------------------------------------------
# Training mix (reference fetch_dataloader, :277-315)
# ---------------------------------------------------------------------------

def aug_params_from_config(train_cfg) -> dict:
    """Build augmentor kwargs from a TrainConfig (reference :280-286)."""
    aug_params = {
        "crop_size": list(train_cfg.image_size),
        "min_scale": train_cfg.spatial_scale[0],
        "max_scale": train_cfg.spatial_scale[1],
        "do_flip": False,
        "yjitter": not train_cfg.noyjitter,
    }
    if getattr(train_cfg, "saturation_range", None) is not None:
        aug_params["saturation_range"] = train_cfg.saturation_range
    if getattr(train_cfg, "img_gamma", None) is not None:
        aug_params["gamma"] = train_cfg.img_gamma
    if getattr(train_cfg, "do_flip", None) is not None:
        aug_params["do_flip"] = train_cfg.do_flip
    return aug_params


def fetch_dataset(train_cfg, root: Optional[str] = None) -> StereoDataset:
    """Concatenate the requested datasets with the reference's oversampling
    weights: sceneflow = clean*4 + final*4, sintel*140, falling_things*5."""
    aug_params = aug_params_from_config(train_cfg)
    root_kw = {"root": root} if root is not None else {}

    mixed = None
    for name in train_cfg.train_datasets:
        if re.fullmatch("middlebury_.*", name):
            ds = Middlebury(aug_params, split=name.replace("middlebury_", ""),
                            **root_kw)
        elif name == "sceneflow":
            clean = SceneFlowDatasets(aug_params, dstype="frames_cleanpass",
                                      **root_kw)
            final = SceneFlowDatasets(aug_params, dstype="frames_finalpass",
                                      **root_kw)
            ds = clean * 4 + final * 4
        elif "kitti" in name:
            ds = KITTI(aug_params, split=name, **root_kw)
        elif name == "sintel_stereo":
            ds = SintelStereo(aug_params, **root_kw) * 140
        elif name == "falling_things":
            ds = FallingThings(aug_params, **root_kw) * 5
        elif name.startswith("tartan_air"):
            ds = TartanAir(aug_params, keywords=name.split("_")[2:], **root_kw)
        else:
            raise ValueError(f"unknown training dataset {name!r}")
        logger.info("Adding %d samples from %s", len(ds), name)
        mixed = ds if mixed is None else mixed + ds

    if mixed is None:
        raise ValueError("train_datasets is empty")
    logger.info("Training with %d image pairs", len(mixed))
    return mixed
