"""The port's data pipeline (raft_stereo_tpu_torch.data) against the
JAX package's on the same files and the same ``np.random.Generator`` seeds,
on the CPU (mirroring tests/test_data.py and tests/test_native.py).

The port reads no OpenCV. Its two replacements are held to OpenCV here,
with the fraction of values that differ recorded:

- ``augmentor.resize_linear`` against ``cv2.resize(..., INTER_LINEAR)``:
  float32 maps within 1e-4, uint8 images within one grey level (OpenCV's
  vectorized 8-bit path rounds a few pixels apart from its scalar
  fixed-point formula, which the port follows: at most 1% of values);
- the hue rotation's uint8 HSV round trip (``photometric.rgb_to_hsv8`` bit
  for bit ``COLOR_RGB2HSV``, ``hsv8_to_rgb`` within one count of
  ``COLOR_HSV2RGB``, at most 3% of values).

Everything else equals the JAX package's: the readers and writers (PFM,
``.flo``, KITTI's 16-bit PNG, Sintel, FallingThings, TartanAir, Middlebury),
the datasets' path lists and samples, the training mix's weights, the
loaders' batches without augmentation, and with it the same crops and
draws, the images within the two replacements' one-count differences. The
port's jitter is numpy only: it equals the JAX package's numpy path bit for
bit, and its C++ kernels within one count.
"""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch
from PIL import Image

import cv2

from raft_stereo_tpu.data import augmentor as jx_aug
from raft_stereo_tpu.data import datasets as jx_ds
from raft_stereo_tpu.data import frame_utils as jx_fu
from raft_stereo_tpu.data import loader as jx_loader
from raft_stereo_tpu.data import photometric as jx_photo

from raft_stereo_tpu import native as jx_native

from raft_stereo_tpu_torch import TrainConfig
from raft_stereo_tpu_torch.data import augmentor, datasets, frame_utils, loader, photometric


def _write_png(path, arr):
    os.makedirs(osp.dirname(str(path)), exist_ok=True)
    Image.fromarray(arr).save(path)


def _sceneflow_tree(root, n=3, h=48, w=64, gray=False):
    rng = np.random.default_rng(5)
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        for i in range(n):
            base = osp.join(root, "FlyingThings3D", dstype, "TRAIN", "A", f"{i:04d}")
            shape = (h, w) if gray else (h, w, 3)
            _write_png(osp.join(base, "left", "0006.png"), rng.integers(0, 256, shape, np.uint8))
            _write_png(osp.join(base, "right", "0006.png"), rng.integers(0, 256, shape, np.uint8))
    for i in range(n):
        base = osp.join(root, "FlyingThings3D", "disparity", "TRAIN", "A", f"{i:04d}", "left")
        os.makedirs(base, exist_ok=True)
        frame_utils.write_pfm(osp.join(base, "0006.pfm"),
                              rng.uniform(0, 30, (h, w)).astype(np.float32))
    return root


# -- readers and writers -------------------------------------------------------


def test_pfm_both_ways(tmp_path, rng):
    disp = rng.uniform(0, 300, (7, 9)).astype(np.float32)
    frame_utils.write_pfm(str(tmp_path / "p.pfm"), disp)
    jx_fu.write_pfm(str(tmp_path / "j.pfm"), disp)
    assert (tmp_path / "p.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(frame_utils.read_pfm(str(tmp_path / "j.pfm")), disp)
    data = rng.uniform(size=(5, 6, 3)).astype(np.float32)
    with open(tmp_path / "c.pfm", "wb") as f:
        f.write(b"PF\n6 5\n1.0\n")  # big-endian color
        f.write(np.flipud(data).astype(">f4").tobytes())
    for fu in (frame_utils, jx_fu):
        np.testing.assert_array_equal(fu.read_pfm(str(tmp_path / "c.pfm")), data)
        assert fu.read_gen(str(tmp_path / "c.pfm")).shape == (5, 6, 2)


def test_flo_both_ways(tmp_path, rng):
    flow = rng.standard_normal((6, 7, 2)).astype(np.float32)
    frame_utils.write_flow(str(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(jx_fu.read_flow(str(tmp_path / "a.flo")), flow)
    np.testing.assert_array_equal(frame_utils.read_gen(str(tmp_path / "a.flo")), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    assert frame_utils.read_flow(str(tmp_path / "bad.flo")) is None


def test_kitti_disparity_png_both_ways(tmp_path):
    disp = np.zeros((5, 8), np.float32)
    disp[1:, 2:] = 37.25
    cv2.imwrite(str(tmp_path / "cv.png"), (disp * 256).astype(np.uint16))
    frame_utils.write_disp_kitti(str(tmp_path / "pil.png"), disp)
    for path in ("cv.png", "pil.png"):
        got, valid = frame_utils.read_disp_kitti(str(tmp_path / path))
        ref, rvalid = jx_fu.read_disp_kitti(str(tmp_path / path))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(valid, rvalid)
        np.testing.assert_array_equal(got, disp)


def test_dataset_readers_equal_jax(tmp_path):
    rgb = np.zeros((3, 4, 3), np.uint8)
    rgb[..., 0], rgb[..., 1] = 100, 128
    _write_png(tmp_path / "disparities" / "s" / "frame_0001.png", rgb)
    _write_png(tmp_path / "occlusions" / "s" / "frame_0001.png", np.zeros((3, 4), np.uint8))
    Image.fromarray(np.full((4, 6), 2000, np.uint16)).save(tmp_path / "x.left.depth.png")
    with open(tmp_path / "_camera_settings.json", "w") as f:
        json.dump({"camera_settings": [{"intrinsic_settings": {"fx": 768.0}}]}, f)
    np.save(tmp_path / "d.npy", np.full((3, 3), 8.0, np.float32))
    frame_utils.write_pfm(str(tmp_path / "disp0GT.pfm"), np.full((4, 5), 12.5, np.float32))
    mask = np.full((4, 5), 255, np.uint8)
    mask[0, 0] = 128
    _write_png(tmp_path / "mask0nocc.png", mask)
    cases = [("read_disp_sintel", "disparities/s/frame_0001.png"),
             ("read_disp_falling_things", "x.left.depth.png"),
             ("read_disp_tartan_air", "d.npy"), ("read_disp_middlebury", "disp0GT.pfm")]
    for name, rel in cases:
        got = getattr(frame_utils, name)(str(tmp_path / rel))
        ref = getattr(jx_fu, name)(str(tmp_path / rel))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(frame_utils.read_disp_sintel(
        str(tmp_path / "disparities/s/frame_0001.png"))[0], 400 + 128 / 64.0)


# -- the two OpenCV replacements ---------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_resize_linear_against_opencv(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(30, 200, 2)
    fx, fy = 2 ** rng.uniform(-0.6, 0.6, 2)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    got = augmentor.resize_linear(img, fx, fy)
    ref = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref)
    print(f"uint8 resize: {float((diff > 0).mean()):.5f} of values one grey level apart")
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    flow = (rng.standard_normal((h, w, 2)) * 30).astype(np.float32)
    got = augmentor.resize_linear(flow, fx, fy)
    ref = cv2.resize(flow, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_hsv_round_trip_against_opencv(rng):
    img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    img[:8] = img[:8, :, :1]  # grey rows: zero saturation
    hsv = photometric.rgb_to_hsv8(img)
    np.testing.assert_array_equal(hsv, cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    back = photometric.hsv8_to_rgb(hsv).astype(int)
    diff = np.abs(back - cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    print(f"HSV2RGB: {float((diff > 0).mean()):.5f} of values one count apart")
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.03
    for shift in (0.13, -0.07):
        a = photometric.adjust_hue(img.astype(np.float32), shift)
        b = jx_photo.adjust_hue(img.astype(np.float32), shift)
        assert np.abs(a - b).max() <= 1


# -- photometric jitter -----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_color_jitter_equals_jax_without_hue(seed, monkeypatch):
    """Hue off: the port's jitter draws and computes what the JAX package's
    numpy path does, bit for bit (the same numpy arithmetic)."""
    img = np.random.default_rng(seed).integers(0, 256, (32, 40, 3)).astype(np.uint8)
    kw = dict(brightness=0.4, contrast=0.4, saturation=(0.0, 1.4), hue=0.0,
              gamma=(0.8, 1.2, 0.9, 1.1))
    got = photometric.ColorJitter(**kw)(img, np.random.default_rng(seed))
    monkeypatch.setattr(jx_native, "_tried", True)
    monkeypatch.setattr(jx_native, "_lib", None)
    ref = jx_photo.ColorJitter(**kw)(img, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(3))
def test_color_jitter_within_one_count_of_jax_with_hue(seed):
    img = np.random.default_rng(seed).integers(0, 256, (32, 40, 3)).astype(np.uint8)
    kw = dict(brightness=0.4, contrast=0.4, saturation=(0.6, 1.4), hue=0.5 / 3.14)
    got = photometric.ColorJitter(**kw)(img, np.random.default_rng(seed)).astype(int)
    ref = jx_photo.ColorJitter(**kw)(img, np.random.default_rng(seed))
    assert np.abs(got - ref).max() <= 2


def test_numpy_jitter_within_one_count_of_jax_native(rng):
    """Hue off: the port's numpy jitter against the JAX package's C++
    kernels on the same draws, within one uint8 count (float32 sums in
    another order)."""
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    kw = dict(brightness=0.4, contrast=0.4, saturation=(0.0, 1.4), hue=0.0,
              gamma=(0.8, 1.2, 0.9, 1.1))
    assert jx_native.available()
    for seed in range(4):
        got = photometric.ColorJitter(**kw)(img, np.random.default_rng(seed)).astype(int)
        ref = jx_photo.ColorJitter(**kw)(img, np.random.default_rng(seed))
        assert np.abs(got - ref).max() <= 1, seed


# -- augmentors ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_dense_augmentor_matches_jax(seed):
    """The same draws: equal crops and shapes, flow within the float
    resize's 1e-4, images within the resize's and hue's one count each."""
    rng = np.random.default_rng(100 + seed)
    img1 = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    img2 = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    flow = np.stack([-rng.uniform(0, 20, (120, 160)), np.zeros((120, 160))], -1).astype(
        np.float32)
    kw = dict(crop_size=(64, 96), min_scale=-0.2, max_scale=0.4, do_flip=False, yjitter=True,
              saturation_range=(0.0, 1.4))
    got = augmentor.FlowAugmentor(**kw)(img1, img2, flow, np.random.default_rng(seed))
    ref = jx_aug.FlowAugmentor(**kw)(img1, img2, flow, np.random.default_rng(seed))
    for a, b in zip(got[:2], ref[:2]):
        assert a.shape == b.shape == (64, 96, 3)
        assert np.abs(a.astype(int) - b).max() <= 3
        assert (a != b).mean() < 0.1
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-4)


def test_sparse_augmentor_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (100, 140, 3)).astype(np.uint8)
    flow = np.stack([-rng.uniform(0, 20, (100, 140)), np.zeros((100, 140))], -1).astype(
        np.float32)
    valid = (rng.uniform(size=(100, 140)) > 0.5).astype(np.float32)
    kw = dict(crop_size=(48, 64), min_scale=-0.2, max_scale=0.4)
    got = augmentor.SparseFlowAugmentor(**kw)(img, img, flow, valid, np.random.default_rng(3))
    ref = jx_aug.SparseFlowAugmentor(**kw)(img, img, flow, valid, np.random.default_rng(3))
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    assert np.abs(got[0].astype(int) - ref[0]).max() <= 3


# -- datasets and loaders ----------------------------------------------------------------


def test_sceneflow_dataset_equals_jax(tmp_path):
    root = _sceneflow_tree(str(tmp_path))
    a = datasets.SceneFlowDatasets(aug_params=None, root=root)
    b = jx_ds.SceneFlowDatasets(aug_params=None, root=root)
    assert a.image_list == b.image_list and a.disparity_list == b.disparity_list
    for i in range(len(a)):
        sa, sb = a.__getitem__(i), b.__getitem__(i)
        for k in ("image1", "image2", "flow", "valid"):
            np.testing.assert_array_equal(sa[k], sb[k])
    gray = _sceneflow_tree(str(tmp_path / "g"), gray=True)
    s = datasets.SceneFlowDatasets(aug_params=None, root=gray).__getitem__(0)
    assert s["image1"].shape == (48, 64, 3) and (s["image1"][..., 0] == s["image1"][..., 2]).all()


def test_training_mix_matches_jax(tmp_path):
    root = _sceneflow_tree(str(tmp_path))
    kroot = root  # fetch_dataset hands every dataset the same root
    img = np.random.default_rng(0).integers(0, 256, (40, 60, 3), dtype=np.uint8)
    for cam in ("image_2", "image_3"):
        _write_png(osp.join(kroot, "training", cam, "000000_10.png"), img)
    os.makedirs(osp.join(kroot, "training", "disp_occ_0"), exist_ok=True)
    frame_utils.write_disp_kitti(osp.join(kroot, "training", "disp_occ_0", "000000_10.png"),
                                 np.full((40, 60), 37.5))
    tcfg = TrainConfig(train_datasets=("sceneflow", "kitti"), image_size=(32, 48),
                       spatial_scale=(-0.2, 0.4))
    a = datasets.fetch_dataset(tcfg, root=root)
    b = jx_ds.fetch_dataset(tcfg, root=root)
    assert len(a) == len(b) == 3 * 8 + 1
    k = a.__getitem__(len(a) - 1, rng=np.random.default_rng(0))
    np.testing.assert_allclose(k["flow"][k["valid"] > 0][..., 0], -37.5)
    assert len(datasets.KITTI(aug_params=None, root=kroot, split="kitti")) == 1


@pytest.mark.parametrize("aug", [False, True])
def test_loader_batches_match_jax(tmp_path, aug):
    root = _sceneflow_tree(str(tmp_path), n=4)
    params = ({"crop_size": [32, 48], "min_scale": -0.2, "max_scale": 0.4, "do_flip": False,
               "yjitter": True} if aug else None)
    a = loader.StereoLoader(datasets.SceneFlowDatasets(params, root=root), batch_size=2,
                            num_workers=2, seed=3)
    b = jx_loader.StereoLoader(jx_ds.SceneFlowDatasets(params, root=root), batch_size=2,
                               num_workers=2, seed=3)
    for _ in range(2):
        for ba, bb in zip(a, b):
            np.testing.assert_array_equal(ba["flow"], bb["flow"]) if not aug else \
                np.testing.assert_allclose(ba["flow"], bb["flow"], atol=1e-4)
            assert np.abs(ba["image1"] - bb["image1"]).max() <= (3 if aug else 0)
    assert a.epoch == b.epoch == 2


def test_loader_resume_at_gives_the_continued_batches(tmp_path):
    root = _sceneflow_tree(str(tmp_path), n=4)
    make = lambda: loader.StereoLoader(datasets.SceneFlowDatasets(None, root=root),  # noqa: E731
                                       batch_size=1, num_workers=1, seed=9)
    full = make()
    seq = [b["image1"] for _ in range(2) for b in full]
    for step in (0, 3, 5, 6):
        part = make()
        part.resume_at(step)
        rest = [b["image1"] for b in part] + [b["image1"] for b in part]
        assert all((x == y).all() for x, y in zip(rest, seq[step:]))


def test_device_prefetch_order_dtype_and_flush():
    batches = [{"image1": np.full((1, 2, 2, 3), i, np.float32),
                "flow": np.zeros((1, 2, 2, 1), np.float32)} for i in range(5)]
    out = list(loader.device_prefetch(iter(batches), None, size=2, image_dtype=torch.bfloat16))
    assert [int(b["image1"][0, 0, 0, 0]) for b in out] == list(range(5))
    assert out[0]["image1"].dtype == torch.bfloat16 and out[0]["flow"].dtype == torch.float32
