"""Image reading behind the decompression-bomb guard.

The port's copy of the guard in the JAX package's ``data/frame_utils.py``:
PIL parses an image's header lazily, so the pixel count the header declares
is checked against ``RAFT_DECODE_MAX_PIXELS`` before the array conversion
runs the decoder. A crafted PNG of a few hundred bytes that declares 100 MP
costs a header read, never a 300 MB allocation. The violation is
:class:`ImageTooLarge`, whose stable code ``image_too_large`` the HTTP
ingress serves as 413.

PIL is imported inside the functions: ``import raft_stereo_tpu_torch.serve``
must not need it. The disparity and flow readers (PFM, KITTI PNG, ``.flo``)
come with training's ``data/``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

#: Default cap on an image's header-declared pixel count (~33.5 MP): four
#: times the serving admission cap (8 MP), so a legitimately large frame is
#: still rejected by admission with its own ``too_large`` code.
DEFAULT_DECODE_MAX_PIXELS = 32 << 20


class ImageTooLarge(ValueError):
    """The header declares more pixels than the decode cap. Raised before
    any full decode; ``code`` is the stable serving rejection code."""

    code = "image_too_large"


def resolve_decode_max_pixels(value: Optional[int] = None) -> int:
    """The decode pixel cap: an explicit value, else
    ``RAFT_DECODE_MAX_PIXELS``, else the default. A malformed value raises a
    ValueError that names the variable."""
    if value is not None:
        return int(value)
    raw = os.environ.get("RAFT_DECODE_MAX_PIXELS", "").strip()
    if not raw:
        return DEFAULT_DECODE_MAX_PIXELS
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"RAFT_DECODE_MAX_PIXELS must be an integer pixel count, "
                         f"got {raw!r}") from None


def guard_decode_size(size, source: str = "image",
                      max_pixels: Optional[int] = None) -> None:
    """Reject a decode whose header declares more pixels than the cap.
    ``size`` is PIL's ``(width, height)``."""
    w, h = int(size[0]), int(size[1])
    cap = resolve_decode_max_pixels(max_pixels)
    if w * h > cap:
        raise ImageTooLarge(f"{source}: header declares {w}x{h} = {w * h} px, above the "
                            f"decode cap of {cap} px (RAFT_DECODE_MAX_PIXELS)")


def read_image_rgb(path) -> np.ndarray:
    """An image as (H, W, 3) uint8: grayscale tiled to 3 channels, alpha
    dropped. The header's pixel count is checked before the decode
    (:class:`ImageTooLarge`); PIL's own bomb tripwire
    (``DecompressionBombError``, raised inside ``open`` for declarations
    far above the default cap) is folded into the same error."""
    from PIL import Image
    ext = os.path.splitext(str(path))[-1].lower()
    if ext in (".bin", ".raw"):
        img = np.load(path)
    else:
        try:
            img = Image.open(path)
        except Image.DecompressionBombError as e:
            raise ImageTooLarge(f"{path}: {e}") from e
        guard_decode_size(img.size, source=str(path))
    img = np.asarray(img).astype(np.uint8)
    if img.ndim == 2:
        return np.tile(img[..., None], (1, 1, 3))
    return img[..., :3]
