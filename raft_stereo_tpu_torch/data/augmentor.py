"""Dense and sparse stereo augmentors (reference ``core/utils/augmentor.py``).

Semantics preserved from the reference, numpy-native with explicit RNG:

- photometric jitter, asymmetric per-eye with prob 0.2 (dense only; the sparse
  augmentor is always symmetric, :204-208);
- eraser occlusion: 1-2 rectangles of img2 filled with its mean color,
  prob 0.5, side 50-100 px (:98-111);
- spatial: log-uniform scale ``2**U(min,max)``, independent x/y stretch with
  prob 0.8 (dense only), clipped so the crop fits (:113-135, :257-273);
- stereo-correct h-flip: swap the eyes and mirror both (:143-146), plus 'hf'
  and 'v' variants;
- y-jitter: img2 cropped at ``y0 + U{-2..2}`` to simulate imperfect
  rectification (:153-160, dense only);
- sparse flow resize: nearest-pixel scatter of valid vectors (:223-255);
- sparse crop with margins y=20 / x=50 (:291-303).

Every random draw goes through a passed-in ``np.random.Generator`` — no global
RNG state, so loader workers are reproducible by construction (the reference
reseeds global RNGs per worker instead, ``stereo_datasets.py:55-61``).

The port's copy of the JAX package's ``data/augmentor.py``, without
OpenCV: :func:`resize_linear` is ``cv2.resize(img, None, fx=fx, fy=fy,
interpolation=cv2.INTER_LINEAR)`` in numpy (its output size, its source
coordinates and edge clamps; float32 maps in its float32 arithmetic, uint8
images in its 11-bit fixed point), held against OpenCV by the CPU tests.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from raft_stereo_tpu_torch.data.photometric import ColorJitter

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _axis_taps(n_src: int, n_dst: int, scale: float):
    """Source taps and weights along one axis: ``src = (d + 0.5) * scale -
    0.5`` rounded to float32, clamped to the first and last sample."""
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int64)
    frac = f - s0.astype(np.float32)
    edge = (s0 < 0) | (s0 >= n_src - 1)
    s0 = np.clip(s0, 0, n_src - 1)
    frac[edge] = 0.0
    return s0, np.minimum(s0 + 1, n_src - 1), frac


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=fx, fy=fy, interpolation=INTER_LINEAR)``
    for an (H, W) or (H, W, C) uint8 or float32 array: the output is
    ``round(W * fx) x round(H * fy)``; a row pass, then a column pass."""
    h, w = img.shape[:2]
    oh, ow = int(np.rint(h * fy)), int(np.rint(w * fx))
    x0, x1, ax = _axis_taps(w, ow, 1.0 / fx)
    y0, y1, ay = _axis_taps(h, oh, 1.0 / fy)
    extra = (None,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        a1 = np.rint(ax * _COEF_SCALE).astype(np.int64)
        a0 = np.rint((1.0 - ax) * _COEF_SCALE).astype(np.int64)
        b1 = np.rint(ay * _COEF_SCALE).astype(np.int64)
        b0 = np.rint((1.0 - ay) * _COEF_SCALE).astype(np.int64)
        src = img.astype(np.int64)
        rows = src[:, x0] * a0[(None, slice(None)) + extra] + src[:, x1] * a1[
            (None, slice(None)) + extra]
        r0, r1 = rows[y0] >> 4, rows[y1] >> 4
        bb0, bb1 = b0[(slice(None), None) + extra], b1[(slice(None), None) + extra]
        out = (((bb0 * r0) >> 16) + ((bb1 * r1) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    one = np.float32(1.0)
    rows = (src[:, x0] * (one - ax)[(None, slice(None)) + extra]
            + src[:, x1] * ax[(None, slice(None)) + extra])
    ay_ = ay[(slice(None), None) + extra]
    return (rows[y0] * (one - ay_) + rows[y1] * ay_).astype(img.dtype)


_resize_linear = resize_linear


def resize_sparse_flow_map(flow: np.ndarray, valid: np.ndarray,
                           fx: float = 1.0, fy: float = 1.0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Rescale a sparse flow field by scattering valid vectors to their
    nearest target pixel (bilinear resize would bleed across the valid mask —
    reference :223-255)."""
    ht, wd = flow.shape[:2]
    ys, xs = np.nonzero(valid >= 1)
    vecs = flow[ys, xs] * [fx, fy]

    ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
    xs1 = np.round(xs * fx).astype(np.int32)
    ys1 = np.round(ys * fy).astype(np.int32)
    keep = (xs1 > 0) & (xs1 < wd1) & (ys1 > 0) & (ys1 < ht1)

    flow_out = np.zeros((ht1, wd1, 2), np.float32)
    valid_out = np.zeros((ht1, wd1), np.int32)
    flow_out[ys1[keep], xs1[keep]] = vecs[keep]
    valid_out[ys1[keep], xs1[keep]] = 1
    return flow_out, valid_out


class FlowAugmentor:
    """Dense augmentor for datasets with full ground-truth disparity."""

    sparse = False

    def __init__(self, crop_size: Sequence[int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip=True, yjitter: bool = False,
                 saturation_range: Sequence[float] = (0.6, 1.4),
                 gamma: Sequence[float] = (1, 1, 1, 1)):
        self.crop_size = tuple(crop_size)
        self.min_scale, self.max_scale = min_scale, max_scale
        self.spatial_aug_prob = 1.0
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.yjitter = yjitter
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = ColorJitter(brightness=0.4, contrast=0.4,
                                     saturation=saturation_range,
                                     hue=0.5 / 3.14, gamma=gamma)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.eraser_bounds = (50, 100)

    # -- photometric ------------------------------------------------------

    def color_transform(self, img1, img2, rng):
        if rng.random() < self.asymmetric_color_aug_prob:
            return self.photo_aug(img1, rng), self.photo_aug(img2, rng)
        stack = np.concatenate([img1, img2], axis=0)
        img1, img2 = np.split(self.photo_aug(stack, rng), 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, rng):
        """Paint random rectangles of img2 with its mean color — simulated
        occlusions that have no stereo correspondence."""
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(*self.eraser_bounds)
                dy = rng.integers(*self.eraser_bounds)
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    # -- spatial ----------------------------------------------------------

    def _sample_scales(self, ht, wd, rng, margin: int):
        min_scale = max((self.crop_size[0] + margin) / float(ht),
                        (self.crop_size[1] + margin) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if self.stretch_prob > 0 and rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        return max(scale_x, min_scale), max(scale_y, min_scale)

    def _flip(self, img1, img2, flow, rng, valid=None):
        """Flip augmentations; ``valid`` (sparse GT mask) flips with the flow.

        The reference never flips the sparse valid mask (augmentor.py:275-289
        touches only img/flow), silently misaligning supervision when flips
        are enabled on sparse datasets — fixed here.
        """
        if not self.do_flip:
            return img1, img2, flow, valid
        if self.do_flip == "hf" and rng.random() < self.h_flip_prob:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1] if valid is not None else None
        if self.do_flip == "h" and rng.random() < self.h_flip_prob:
            # Stereo-correct: mirroring swaps the roles of the two eyes.
            img1, img2 = img2[:, ::-1], img1[:, ::-1]
        if self.do_flip == "v" and rng.random() < self.v_flip_prob:
            img1, img2 = img1[::-1, :], img2[::-1, :]
            flow = flow[::-1, :] * [1.0, -1.0]
            valid = valid[::-1, :] if valid is not None else None
        return img1, img2, flow, valid

    def spatial_transform(self, img1, img2, flow, rng):
        ch, cw = self.crop_size
        scale_x, scale_y = self._sample_scales(*img1.shape[:2], rng, margin=8)
        if rng.random() < self.spatial_aug_prob:
            img1 = _resize_linear(img1, scale_x, scale_y)
            img2 = _resize_linear(img2, scale_x, scale_y)
            flow = _resize_linear(flow, scale_x, scale_y) * [scale_x, scale_y]
        img1, img2, flow, _ = self._flip(img1, img2, flow, rng)

        if self.yjitter:
            y0 = int(rng.integers(2, img1.shape[0] - ch - 2))
            x0 = int(rng.integers(2, img1.shape[1] - cw - 2))
            y1 = y0 + int(rng.integers(-2, 3))
            img2 = img2[y1:y1 + ch, x0:x0 + cw]
        else:
            y0 = int(rng.integers(0, img1.shape[0] - ch))
            x0 = int(rng.integers(0, img1.shape[1] - cw))
            img2 = img2[y0:y0 + ch, x0:x0 + cw]
        img1 = img1[y0:y0 + ch, x0:x0 + cw]
        flow = flow[y0:y0 + ch, x0:x0 + cw]
        return img1, img2, flow

    def __call__(self, img1, img2, flow, rng: np.random.Generator):
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


class SparseFlowAugmentor(FlowAugmentor):
    """Augmentor for sparse ground truth (KITTI/ETH3D/Middlebury/Sintel):
    symmetric-only color, scatter-based flow resize, margin crop."""

    sparse = True

    def __init__(self, crop_size: Sequence[int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip=False, yjitter: bool = False,
                 saturation_range: Sequence[float] = (0.7, 1.3),
                 gamma: Sequence[float] = (1, 1, 1, 1)):
        super().__init__(crop_size, min_scale, max_scale, do_flip, yjitter,
                         saturation_range, gamma)
        self.photo_aug = ColorJitter(brightness=0.3, contrast=0.3,
                                     saturation=saturation_range,
                                     hue=0.3 / 3.14, gamma=gamma)
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.0  # sparse spatial aug is isotropic (:265-267)
        self.crop_margin = (20, 50)  # (y, x), reference :291-292

    def color_transform(self, img1, img2, rng):
        stack = np.concatenate([img1, img2], axis=0)
        return tuple(np.split(self.photo_aug(stack, rng), 2, axis=0))

    def spatial_transform(self, img1, img2, flow, valid, rng):
        ch, cw = self.crop_size
        scale_x, scale_y = self._sample_scales(*img1.shape[:2], rng, margin=1)
        if rng.random() < self.spatial_aug_prob:
            img1 = _resize_linear(img1, scale_x, scale_y)
            img2 = _resize_linear(img2, scale_x, scale_y)
            flow, valid = resize_sparse_flow_map(flow, valid, scale_x, scale_y)
        img1, img2, flow, valid = self._flip(img1, img2, flow, rng, valid)

        margin_y, margin_x = self.crop_margin
        y0 = int(rng.integers(0, img1.shape[0] - ch + margin_y))
        x0 = int(rng.integers(-margin_x, img1.shape[1] - cw + margin_x))
        y0 = int(np.clip(y0, 0, img1.shape[0] - ch))
        x0 = int(np.clip(x0, 0, img1.shape[1] - cw))
        return (img1[y0:y0 + ch, x0:x0 + cw], img2[y0:y0 + ch, x0:x0 + cw],
                flow[y0:y0 + ch, x0:x0 + cw], valid[y0:y0 + ch, x0:x0 + cw])

    def __call__(self, img1, img2, flow, valid, rng: np.random.Generator):
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow, valid = self.spatial_transform(
            img1, img2, flow, valid, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))
