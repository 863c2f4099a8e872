"""Pad NHWC images so H and W divide the network's stride.

Reference ``core/utils/utils.py:7-26``: replicate padding, centred in
'sintel' mode; otherwise W is centred and H padded at the bottom. The
optional ``bucket`` rounds H and W up to a multiple of ``bucket`` instead, so
mixed-size inputs share shapes. ``unpad`` restores the original extent.
``pad_np`` and ``unpad_np`` do the same on numpy arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class InputPadder:
    """Pads (B, H, W, C) tensors so H, W are divisible by ``divis_by``."""

    def __init__(self, dims: Sequence[int], mode: str = "sintel",
                 divis_by: int = 8, bucket: Optional[int] = None):
        # dims: an NHWC shape, an (H, W, C) shape, or a bare (H, W) pair.
        if len(dims) >= 3:
            self.ht, self.wd = int(dims[-3]), int(dims[-2])
        else:
            self.ht, self.wd = int(dims[0]), int(dims[1])
        if bucket is not None:
            if bucket % divis_by:
                raise ValueError("bucket size must be a multiple of divis_by")
            pad_ht = (-self.ht) % bucket
            pad_wd = (-self.wd) % bucket
        else:
            pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
            pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2)
        else:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    @property
    def padded_shape(self) -> Tuple[int, int]:
        l, r, t, b = self._pad
        return self.ht + t + b, self.wd + l + r

    def pad(self, *inputs: torch.Tensor) -> list:
        l, r, t, b = self._pad
        # Edge replication over H and W of NHWC: replicate-pad the NCHW view.
        return [F.pad(x.permute(0, 3, 1, 2), (l, r, t, b), mode="replicate")
                .permute(0, 2, 3, 1).contiguous() for x in inputs]

    def pad_np(self, *inputs: np.ndarray) -> list:
        """``pad`` for host arrays (edge replication, as ``pad``): the
        serving session pads numpy pairs before it uploads them."""
        l, r, t, b = self._pad
        return [np.pad(x, ((0, 0), (t, b), (l, r), (0, 0)), mode="edge")
                for x in inputs]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        ht, wd = x.shape[1], x.shape[2]
        return x[:, t:ht - b, l:wd - r, :]

    def unpad_np(self, x: np.ndarray) -> np.ndarray:
        """``unpad`` for host arrays: the same slice, a view."""
        return self.unpad(x)


def bucket_shape(dims: Sequence[int], bucket: int, divis_by: int = 8) -> Tuple[int, int]:
    """Padded (H, W) that ``InputPadder(dims, bucket=bucket)`` would give:
    how the serving layer lists its shape buckets without building padders."""
    return InputPadder(dims, divis_by=divis_by, bucket=bucket).padded_shape
