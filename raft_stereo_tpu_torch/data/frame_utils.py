"""Image reading behind the decompression-bomb guard.

The port's copy of the guard in the JAX package's ``data/frame_utils.py``:
PIL parses an image's header lazily, so the pixel count the header declares
is checked against ``RAFT_DECODE_MAX_PIXELS`` before the array conversion
runs the decoder. A crafted PNG of a few hundred bytes that declares 100 MP
costs a header read, never a 300 MB allocation. The violation is
:class:`ImageTooLarge`, whose stable code ``image_too_large`` the HTTP
ingress serves as 413.

PIL is imported inside the functions: ``import raft_stereo_tpu_torch.serve``
must not need it.

The dataset readers and writers (the JAX package's ``data/frame_utils.py``,
reference ``core/utils/frame_utils.py``): PFM, Middlebury ``.flo``, KITTI's
16-bit disparity PNG, Sintel's RGB-packed disparity, FallingThings depth,
TartanAir depth, Middlebury's ``disp0GT.pfm`` with its non-occlusion mask,
and ``read_gen``. Without OpenCV: the KITTI disparity PNG through Pillow
(its 16-bit grey mode); KITTI's optical-flow PNGs are 16-bit RGB, which
Pillow neither decodes nor writes, so :func:`read_flow_kitti` and
:func:`write_flow_kitti` carry their own PNG codec on numpy and ``zlib``
(the five PNG row filters, no interlace).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np

FLO_MAGIC = 202021.25

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


# ---------------------------------------------------------------------------
# PFM (portable float map)
# ---------------------------------------------------------------------------

def read_pfm(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read a PFM file -> (H, W) or (H, W, 3) float array, top-down rows."""
    with open(path, "rb") as f:
        kind = f.readline().strip()
        if kind == b"PF":
            channels = 3
        elif kind == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {kind!r})")
        dims = f.readline().split()
        if len(dims) != 2:
            raise ValueError(f"{path}: malformed PFM dimensions {dims!r}")
        width, height = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.fromfile(f, dtype, count=width * height * channels)
    shape = (height, width, 3) if channels == 3 else (height, width)
    # PFM stores rows bottom-up; flip to conventional top-down.
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path: Union[str, os.PathLike], array: np.ndarray) -> None:
    """Write a single-channel float PFM (little-endian, bottom-up rows)."""
    if array.ndim != 2:
        raise ValueError(f"write_pfm expects (H, W), got {array.shape}")
    h, w = array.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n%d %d\n-1\n" % (w, h))
        f.write(np.flipud(array).astype("<f4").tobytes())


# ---------------------------------------------------------------------------
# Middlebury .flo optical flow
# ---------------------------------------------------------------------------

def read_flow(path: Union[str, os.PathLike]) -> Optional[np.ndarray]:
    """Read a .flo file -> (H, W, 2) float32, or None on a bad magic."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(FLO_MAGIC):
            return None
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(path: Union[str, os.PathLike], flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 optical flow as .flo."""
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"write_flow expects (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


# ---------------------------------------------------------------------------
# KITTI 16-bit PNG disparity
# ---------------------------------------------------------------------------

def read_disp_kitti(path) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI disparity PNG: uint16 / 256; zero marks invalid."""
    from PIL import Image
    disp = np.asarray(Image.open(path)).astype(np.float64) / 256.0
    return disp, disp > 0.0


def write_disp_kitti(path, disp: np.ndarray) -> None:
    """The inverse of :func:`read_disp_kitti`: ``uint16(disp * 256)``."""
    from PIL import Image
    Image.fromarray((np.asarray(disp) * 256).astype(np.uint16)).save(path)


# ---------------------------------------------------------------------------
# KITTI 16-bit RGB PNG optical flow
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _unfilter_rows(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of ``raw`` (``h`` rows of a filter byte and
    ``stride`` bytes) into an (h, stride) uint8 array."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each byte lane of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prior) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: left to right, a pixel at a time
            cur = line.copy()
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, up_left))
                cur[x:x + bpp] = (cur[x:x + bpp] + pred) & 0xFF
                left, up_left = cur[x:x + bpp], up
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def _read_png16_rgb(path) -> np.ndarray:
    """A 16-bit RGB (or RGBA, alpha dropped) PNG as (H, W, 3) uint16, its
    header's size checked against the decode cap before inflating."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 16 or color not in (2, 6) or interlace != 0:
        raise ValueError(f"{path}: a KITTI flow PNG is 16-bit RGB without interlace, got "
                         f"bit depth {depth}, color type {color}, interlace {interlace}")
    guard_decode_size((w, h), source=str(path))
    channels = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * channels * 2
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data of {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    pixels = _unfilter_rows(raw, h, stride, channels * 2)
    return pixels.view(">u2").reshape(h, w, channels)[..., :3].astype(np.uint16)


def _write_png16_rgb(path, rgb: np.ndarray) -> None:
    """(H, W, 3) uint16 as a 16-bit RGB PNG, every row unfiltered."""
    h, w, _ = rgb.shape
    rows = np.ascontiguousarray(rgb, ">u2").reshape(h, w * 3).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(_png_chunk(b"IEND", b""))


def read_flow_kitti(path) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI flow PNG: uint16 channels ``(u, v, valid)``, ``(x - 2^15)/64``;
    returns the (H, W, 2) flow and the valid channel, float32."""
    raw = _read_png16_rgb(path).astype(np.float32)
    flow = (raw[:, :, :2] - 2 ** 15) / 64.0
    return flow, raw[:, :, 2]


def write_flow_kitti(path, flow: np.ndarray) -> None:
    """The inverse of :func:`read_flow_kitti`, every pixel valid."""
    enc = 64.0 * flow + 2 ** 15
    valid = np.ones((*flow.shape[:2], 1), flow.dtype)
    _write_png16_rgb(path, np.concatenate([enc, valid], axis=-1).astype(np.uint16))


# The reference's names.
readFlowKITTI = read_flow_kitti
writeFlowKITTI = write_flow_kitti


# ---------------------------------------------------------------------------
# Per-dataset disparity readers (each -> (disp, valid))
# ---------------------------------------------------------------------------

def read_disp_sintel(path) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel packs disparity into RGB: ``r*4 + g/64 + b/16384``; the paired
    ``occlusions/`` PNG marks occluded pixels (nonzero).

    Deviation from the reference (:130-136): the decode is done in float64.
    The reference multiplies the uint8 R channel by 4 before promotion, which
    wraps mod 256 for disparities >= 256 px under value-based casting — a
    latent overflow this implementation fixes.
    """
    from PIL import Image
    rgb = np.asarray(Image.open(path), dtype=np.float64)
    disp = rgb[..., 0] * 4 + rgb[..., 1] / 2 ** 6 + rgb[..., 2] / 2 ** 14
    occ = np.asarray(Image.open(str(path).replace("disparities", "occlusions")))
    return disp, (occ == 0) & (disp > 0)


def read_disp_falling_things(path) -> Tuple[np.ndarray, np.ndarray]:
    """FallingThings depth PNG -> disparity with the 6 cm baseline:
    ``disp = fx * 6.0 * 100 / depth`` (fx from _camera_settings.json)."""
    from PIL import Image
    depth = np.asarray(Image.open(path)).astype(np.float32)
    settings = os.path.join(os.path.dirname(str(path)), "_camera_settings.json")
    with open(settings) as f:
        fx = json.load(f)["camera_settings"][0]["intrinsic_settings"]["fx"]
    disp = (fx * 6.0 * 100) / depth
    return disp, disp > 0


def read_disp_tartan_air(path) -> Tuple[np.ndarray, np.ndarray]:
    """TartanAir depth .npy -> ``disp = 80 / depth``."""
    disp = 80.0 / np.load(path)
    return disp, disp > 0


def read_disp_middlebury(path) -> Tuple[np.ndarray, np.ndarray]:
    """Middlebury ``disp0GT.pfm`` with its ``mask0nocc.png`` (255 = nocc)."""
    path = str(path)
    if os.path.basename(path) != "disp0GT.pfm":
        raise ValueError(f"expected a disp0GT.pfm path, got {path}")
    disp = read_pfm(path).astype(np.float32)
    if disp.ndim != 2:
        raise ValueError(f"{path}: disparity PFM must be single-channel")
    from PIL import Image
    mask_path = path.replace("disp0GT.pfm", "mask0nocc.png")
    nocc = np.asarray(Image.open(mask_path)) == 255
    if not nocc.any():
        raise ValueError(f"{mask_path}: empty non-occlusion mask")
    return disp, nocc


# ---------------------------------------------------------------------------
# Generic dispatch
# ---------------------------------------------------------------------------

def read_gen(path, pil: bool = False):
    """Extension-dispatched reader (reference ``read_gen``, :173-187).

    Images return PIL Images; ``.pfm`` returns float arrays with the alpha-like
    last channel dropped for 3-channel maps; ``.flo`` returns (H, W, 2).
    """
    from PIL import Image
    ext = os.path.splitext(str(path))[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm"):
        return Image.open(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flow(path).astype(np.float32)
    if ext == ".pfm":
        data = read_pfm(path).astype(np.float32)
        return data if data.ndim == 2 else data[:, :, :-1]
    return []
