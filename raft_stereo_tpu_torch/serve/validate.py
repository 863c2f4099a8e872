"""Admission control: reject malformed requests before they touch a device.

A copy of the JAX package's ``serve/validate.py``.

One bad frame must never cost a compile, an XLA crash, or a garbage
disparity served as truth (DESIGN.md "Serving & degradation"). Every check
here is a cheap host-side numpy predicate; each failure carries a stable
``code`` so callers (and the fault-storm test battery driven by
``faults.malformed_pairs``) can assert on the exact rejection class.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


class InputRejected(ValueError):
    """A request failed admission control; ``code`` is machine-readable."""

    def __init__(self, code: str, message: str):
        self.code = code
        super().__init__(message)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Bounds a request must satisfy to be admitted.

    max_pixels: per-image area cap — the largest shape the operator is
        willing to compile/run (Middlebury-F is ~5.7 MP; the default
        admits it with headroom). Protects against a single huge frame
        triggering an OOM or a multi-minute compile for one request.
    require_finite: scan for NaN/Inf pixels on admission. O(N) on host —
        microseconds per megapixel against a multi-ms forward — and the
        alternative is NaN propagating through 32 GRU iterations into a
        disparity field that fails output validation anyway.
    """

    max_pixels: int = 8 << 20
    require_finite: bool = True


def _as_batched(name: str, img) -> np.ndarray:
    if not isinstance(img, np.ndarray):
        try:
            img = np.asarray(img)
        except Exception as e:  # ragged nested sequences etc.
            raise InputRejected(
                "not_an_array", f"{name}: cannot convert to ndarray: {e}")
    if img.dtype == object or not np.issubdtype(img.dtype, np.number):
        raise InputRejected(
            "bad_dtype", f"{name}: non-numeric dtype {img.dtype}")
    if img.ndim == 3:
        img = img[None]
    if img.ndim != 4:
        raise InputRejected(
            "wrong_rank",
            f"{name}: expected (H, W, 3) or (1, H, W, 3), got {img.shape}")
    if img.shape[0] != 1:
        raise InputRejected(
            "bad_batch", f"{name}: serving is single-pair, got batch "
            f"{img.shape[0]}")
    return img


def validate_pair(left, right,
                  admission: AdmissionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Validate one stereo pair; returns float32 ``(1, H, W, 3)`` arrays.

    Raises :class:`InputRejected` with a stable code on any violation:
    ``not_an_array`` / ``bad_dtype`` / ``wrong_rank`` / ``bad_batch`` /
    ``bad_channels`` / ``zero_area`` / ``too_large`` / ``shape_mismatch`` /
    ``nonfinite_input``.
    """
    left = _as_batched("left", left)
    right = _as_batched("right", right)
    for name, img in (("left", left), ("right", right)):
        if img.shape[-1] != 3:
            raise InputRejected(
                "bad_channels",
                f"{name}: expected 3 channels, got {img.shape[-1]}")
        h, w = img.shape[1], img.shape[2]
        if h <= 0 or w <= 0:
            raise InputRejected(
                "zero_area", f"{name}: zero-area image {img.shape}")
        if h * w > admission.max_pixels:
            raise InputRejected(
                "too_large", f"{name}: {h}x{w} = {h * w} px exceeds the "
                f"admission cap of {admission.max_pixels} px")
    if left.shape != right.shape:
        raise InputRejected(
            "shape_mismatch",
            f"left {left.shape} vs right {right.shape}")
    left = np.ascontiguousarray(left, dtype=np.float32)
    right = np.ascontiguousarray(right, dtype=np.float32)
    if admission.require_finite:
        for name, img in (("left", left), ("right", right)):
            if not np.isfinite(img).all():
                raise InputRejected(
                    "nonfinite_input", f"{name}: contains NaN/Inf pixels")
    return left, right
