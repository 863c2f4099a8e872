"""The reference modules the stereo model does not use, held against the
JAX package on the same seeded weights: ``SepConvGRU``
(``models/update.py``) and ``BottleneckBlock`` (``models/layers.py``), in
fp32 within 1e-5; and the KITTI optical-flow PNG codec
(``data/frame_utils.py``), bit for bit against the JAX package's OpenCV
reader and writer, every PNG row filter included.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import jax

from raft_stereo_tpu.data import frame_utils as jax_frames
from raft_stereo_tpu.models.layers import apply_bottleneck_block, init_bottleneck_block
from raft_stereo_tpu.models.update import apply_sep_conv_gru, init_sep_conv_gru
from raft_stereo_tpu_torch.data import frame_utils
from raft_stereo_tpu_torch.models.layers import BottleneckBlock
from raft_stereo_tpu_torch.models.update import SepConvGRU
from raft_stereo_tpu_torch.transplant import (bottleneck_block_from_jax, load_state_dict,
                                              sep_conv_gru_from_jax)

TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_err(port: torch.Tensor, ref) -> float:
    return float(np.max(np.abs(port.detach().numpy() - np.asarray(ref))))


def test_sep_conv_gru_matches_jax():
    rng = np.random.default_rng(0)
    hidden, parts = 32, (16, 32)
    params = _np_tree(init_sep_conv_gru(jax.random.PRNGKey(1), hidden_dim=hidden,
                                        input_dim=sum(parts)))
    gru = SepConvGRU(hidden_dim=hidden, input_dim=sum(parts))
    load_state_dict(gru, sep_conv_gru_from_jax(params))
    h = rng.standard_normal((2, 12, 20, hidden)).astype(np.float32)
    xs = [rng.standard_normal((2, 12, 20, c)).astype(np.float32) for c in parts]
    ref = apply_sep_conv_gru(params, h, *xs)
    with torch.no_grad():
        got = gru(torch.from_numpy(h), *[torch.from_numpy(x) for x in xs])
    assert got.shape == h.shape
    assert gru.convz1.weight.shape[2:] == (1, 5) and gru.convq2.weight.shape[2:] == (5, 1)
    assert _max_err(got, ref) <= TOL


def _perturb_norms(params, rng):
    """Non-trivial norm parameters and statistics (the init's are 1 and 0)."""
    def walk(p):
        for k, v in p.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "var"):
                p[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                p[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
    walk(params)
    return params


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("norm_fn", ["group", "batch", "instance", "none"])
def test_bottleneck_block_matches_jax(norm_fn, stride):
    rng = np.random.default_rng(stride)
    in_planes, planes = (32, 32) if stride == 1 else (16, 32)
    params = _perturb_norms(_np_tree(init_bottleneck_block(
        jax.random.PRNGKey(2), in_planes, planes, norm_fn, stride=stride)), rng)
    block = BottleneckBlock(in_planes, planes, norm_fn=norm_fn, stride=stride)
    load_state_dict(block, bottleneck_block_from_jax(params, norm_fn))
    block.eval()
    x = rng.standard_normal((2, 24, 36, in_planes)).astype(np.float32)
    ref = apply_bottleneck_block(params, x, norm_fn, stride=stride)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert got.shape == (2, 24 // stride, 36 // stride, planes) == np.asarray(ref).shape
    assert (block.downsample is None) == (stride == 1)
    assert _max_err(got, ref) <= TOL


# -- the KITTI flow PNG --------------------------------------------------------

def _flow(rng, h=37, w=53):
    return rng.uniform(-400.0, 400.0, (h, w, 2)).astype(np.float32)


def _raw16(path) -> np.ndarray:
    """The PNG's uint16 samples as OpenCV decodes them, in RGB order."""
    import cv2
    return cv2.imread(str(path), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)[:, :, ::-1]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_round_trip"])
def test_kitti_flow_png_is_bit_exact_with_the_jax_codec(tmp_path, direction):
    flow = _flow(np.random.default_rng(5))
    writer = (jax_frames.write_flow_kitti if direction == "jax_to_port"
              else frame_utils.write_flow_kitti)
    reader = (jax_frames.read_flow_kitti if direction == "port_to_jax"
              else frame_utils.read_flow_kitti)
    path = tmp_path / "flow.png"
    writer(path, flow)
    got, valid = reader(path)
    ref_path = tmp_path / "ref.png"
    jax_frames.write_flow_kitti(ref_path, flow)
    ref, ref_valid = jax_frames.read_flow_kitti(ref_path)
    assert got.dtype == ref.dtype and valid.dtype == ref_valid.dtype
    assert np.array_equal(got, ref) and np.array_equal(valid, ref_valid)
    assert np.array_equal(_raw16(path), _raw16(ref_path))  # the uint16 values
    assert (valid == 1).all()
    assert np.abs(got - flow).max() <= 1 / 64


def _filtered_png(rgb16: np.ndarray, filters) -> bytes:
    """A 16-bit RGB PNG whose row y is filtered with ``filters[y % len]``
    (the PNG specification's forward filters, from the known image)."""
    h, w, _ = rgb16.shape
    img = np.ascontiguousarray(rgb16, ">u2").reshape(h, w * 3).view(np.uint8).astype(np.int32)
    bpp = 6
    rows = []
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = img[y]
        up = img[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    idat = zlib.compress(b"".join(rows))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + chunk(b"IDAT", idat[:len(idat) // 2]) + chunk(b"IDAT", idat[len(idat) // 2:])
            + chunk(b"IEND", b""))


def test_kitti_flow_png_reader_undoes_every_row_filter(tmp_path):
    """OpenCV writes Sub rows; a PNG of None, Sub, Up, Average and Paeth
    rows, split over two IDAT chunks, decodes to the same samples as
    OpenCV reads from it."""
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 1 << 16, (11, 17, 3)).astype(np.uint16)
    rgb[..., 2] = rng.integers(0, 2, (11, 17))
    path = tmp_path / "filters.png"
    path.write_bytes(_filtered_png(rgb, (0, 1, 2, 3, 4)))
    assert np.array_equal(_raw16(path), rgb)
    flow, valid = frame_utils.read_flow_kitti(path)
    ref, ref_valid = jax_frames.read_flow_kitti(path)
    assert np.array_equal(flow, ref) and np.array_equal(valid, ref_valid)


def test_kitti_flow_png_reader_guards_the_decode(tmp_path, monkeypatch):
    """The header's size is checked before anything is inflated, as the
    port's other readers do; the aliases are the reference's names."""
    path = tmp_path / "big.png"
    path.write_bytes(_filtered_png(np.zeros((4, 4, 3), np.uint16), (0,)))
    monkeypatch.setenv("RAFT_DECODE_MAX_PIXELS", "15")
    with pytest.raises(frame_utils.ImageTooLarge):
        frame_utils.read_flow_kitti(path)
    monkeypatch.setenv("RAFT_DECODE_MAX_PIXELS", "16")
    assert frame_utils.readFlowKITTI(path)[0].shape == (4, 4, 2)
    assert frame_utils.writeFlowKITTI is frame_utils.write_flow_kitti
