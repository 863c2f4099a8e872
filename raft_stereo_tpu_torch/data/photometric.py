"""Numpy photometric augmentation with torchvision-equivalent semantics.

The reference composes ``torchvision.transforms.ColorJitter`` with a gamma
adjustment (``core/utils/augmentor.py:78,200,47-58``). This module reproduces
those semantics on uint8 numpy arrays with an explicit ``np.random.Generator``:

- brightness/contrast/saturation factors ~ U[max(0, 1-a), 1+a] (or a given
  [lo, hi] range), hue shift ~ U[-h, h] in "turns";
- the four jitter ops are applied in a uniformly random order (torchvision
  shuffles the op order per call);
- blends follow torchvision: brightness scales, contrast blends with the mean
  gray value, saturation blends with per-pixel grayscale (ITU-R 601 weights),
  hue rotates the HSV hue channel;
- gamma: ``out = 255 * gain * (in/255)**gamma``.

The port's copy of the JAX package's ``data/photometric.py``, without
OpenCV: the hue rotation's uint8 HSV round trip (OpenCV's ``RGB2HSV`` /
``HSV2RGB`` with hue in [0, 180)) is written here in numpy, the forward
conversion in OpenCV's integer arithmetic and the inverse in its float32
arithmetic, so the two agree to within one uint8 count (the CPU tests hold
them against OpenCV). The port has no native kernels: the JAX package's
C++ jitter saved a few per cent of a sample's host time, which the
loader's prefetch hides behind a training step on the card (PERF.md).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

_GRAY_WEIGHTS = np.asarray([0.299, 0.587, 0.114], np.float32)  # ITU-R 601

Range = Union[float, Tuple[float, float], Sequence[float]]


def _as_range(value: Range, center: float = 1.0) -> Tuple[float, float]:
    if np.isscalar(value):
        lo, hi = center - float(value), center + float(value)
        return max(0.0, lo), hi
    lo, hi = value
    return float(lo), float(hi)


def _blend(img: np.ndarray, other: np.ndarray, factor: float) -> np.ndarray:
    out = factor * img + (1.0 - factor) * other
    return np.clip(out, 0.0, 255.0)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean_gray = (img @ _GRAY_WEIGHTS).mean()
    return _blend(img, np.full_like(img, mean_gray), factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img @ _GRAY_WEIGHTS)[..., None]
    return _blend(img, np.broadcast_to(gray, img.shape), factor)


_HSV_SHIFT = 12
_SDIV = np.rint((255 << _HSV_SHIFT) / np.maximum(np.arange(256), 1)).astype(np.int64)
_HDIV = np.rint((180 << _HSV_SHIFT) / (6.0 * np.maximum(np.arange(256), 1))).astype(np.int64)
_SDIV[0] = _HDIV[0] = 0
# (b, g, r) taken from tab[v, v(1-s), v(1-sf), v(1-s(1-f))] by hue sector.
_SECTORS = np.asarray([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv8(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> uint8 HSV, hue in [0, 180): OpenCV's ``COLOR_RGB2HSV``
    integer arithmetic (12-bit fixed-point divisions, rounded)."""
    rgb = img.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = rgb.max(axis=-1)
    diff = v - rgb.min(axis=-1)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


def hsv8_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (hue in [0, 180)) -> uint8 RGB: OpenCV's ``COLOR_HSV2RGB``
    float32 arithmetic, truncated to a count."""
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    h = np.fmod(h, np.float32(6.0))
    sector = np.floor(h).astype(np.int64)
    f = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    f = np.where(bad, np.float32(0.0), f)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * f), v * (one - s * (one - f))], axis=-1)
    idx = _SECTORS[sector]  # (..., 3): b, g, r
    bgr = np.take_along_axis(tab, idx, axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    # OpenCV's uint8 exit truncates (its rounding would differ in a third
    # of the values; truncation agrees with it in ~98.6%, the rest by one).
    out = np.clip(np.trunc(bgr * np.float32(255.0)), 0, 255).astype(np.uint8)
    return out[..., ::-1]


def adjust_hue(img: np.ndarray, shift_turns: float) -> np.ndarray:
    """Rotate hue by ``shift_turns`` of a full color wheel (torchvision units)."""
    hsv = rgb_to_hsv8(img.astype(np.uint8))
    h = hsv[..., 0].astype(np.int32)  # hue in [0, 180)
    hsv[..., 0] = ((h + int(round(shift_turns * 180.0))) % 180).astype(np.uint8)
    return hsv8_to_rgb(hsv).astype(np.float32)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    out = 255.0 * gain * np.power(img / 255.0, gamma)
    return np.clip(out, 0.0, 255.0)


class ColorJitter:
    """uint8 (H, W, 3) -> uint8, torchvision ``ColorJitter`` + ``AdjustGamma``."""

    def __init__(self, brightness: Range = 0.0, contrast: Range = 0.0,
                 saturation: Range = 0.0, hue: float = 0.0,
                 gamma: Sequence[float] = (1.0, 1.0, 1.0, 1.0)):
        self.brightness = _as_range(brightness)
        self.contrast = _as_range(contrast)
        self.saturation = _as_range(saturation)
        self.hue = float(hue)
        # gamma bounds are (gamma_min, gamma_max, gain_min, gain_max), with the
        # gain pair defaulting to 1 (reference AdjustGamma, augmentor.py:47-58).
        g = tuple(gamma) + (1.0, 1.0)[:max(0, 4 - len(tuple(gamma)))]
        self.gamma_range, self.gain_range = (g[0], g[1]), (g[2], g[3])

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        out = img.astype(np.float32)
        ops = list(rng.permutation(4))
        b = rng.uniform(*self.brightness)
        c = rng.uniform(*self.contrast)
        s = rng.uniform(*self.saturation)
        h = rng.uniform(-self.hue, self.hue)
        gamma_gain_draw = (rng.uniform(*self.gamma_range),
                           rng.uniform(*self.gain_range))
        for op in ops:
            if op == 0:
                out = adjust_brightness(out, b)
            elif op == 1:
                out = adjust_contrast(out, c)
            elif op == 2:
                out = adjust_saturation(out, s)
            elif op == 3 and self.hue > 0:
                out = adjust_hue(out, h)
        gamma, gain = gamma_gain_draw
        if gamma != 1.0 or gain != 1.0:
            out = adjust_gamma(out, gamma, gain)
        return out.astype(np.uint8)
