"""The port's plain ops and layers (raft_stereo_tpu_torch.ops, .models.layers,
.models.extractor) against their JAX counterparts, on the CPU.

Inputs come from seeded numpy and go to both sides. Tolerances:
- fp32: 1e-5 relative to the output's scale (summation order only);
- bf16: counted in bf16 ulps of the reference value. An op that rounds once
  from an fp32 accumulator may land one ulp apart when the two frameworks
  sum in different orders; chains of rounded ops get a few ulps.

The ops the serving layer needs (``bucket_shape``, ``upflow``,
``avg_pool_w2``, ``pool4x``, the two samplers, ``map_chunked``) are held in
fp32 to the same 1e-5 of scale, and the package's ``ops`` exports to the JAX
package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_stereo_tpu.models import extractor as jx_extractor
from raft_stereo_tpu.models import layers as jx_layers
import raft_stereo_tpu.ops as jx_ops
from raft_stereo_tpu.ops import basic as jx_basic
from raft_stereo_tpu.ops import chunked as jx_chunked
from raft_stereo_tpu.ops import padder as jx_padder
from raft_stereo_tpu.ops import pooling as jx_pooling
from raft_stereo_tpu.ops import resize as jx_resize
from raft_stereo_tpu.ops import sampler as jx_sampler
from raft_stereo_tpu.ops import upsample as jx_upsample
from raft_stereo_tpu.ops.coords import coords_grid as jx_coords_grid
from raft_stereo_tpu.ops.coords import upflow as jx_upflow

from raft_stereo_tpu_torch import transplant
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.models.layers import ResidualBlock
import raft_stereo_tpu_torch.ops as port_ops
from raft_stereo_tpu_torch.ops import basic, chunked, pooling, resize, sampler, upsample
from raft_stereo_tpu_torch.ops.coords import coords_grid, upflow
from raft_stereo_tpu_torch.ops.padder import InputPadder, bucket_shape

import jax

DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The parallel test runner puts several worker processes on one CPU;
    a small intra-op pool keeps these tests from starving the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def both(a: np.ndarray, kind: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    _, jdt, tdt = DTYPES[kind]
    return jnp.asarray(a, dtype=jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def bf16_ulps(got, ref) -> float:
    """Largest |got - ref| in bf16 ulps of ref (ulp of 1.0 for |ref| < 1e-30)."""
    g, r = to_np(got), to_np(ref)
    mag = np.maximum(np.abs(r), 1e-30)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.max(np.abs(g - r) / ulp))


def assert_close(got, ref, kind: str, ulps: float = 1.0, rtol: float = 1e-5):
    g, r = to_np(got), to_np(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    if kind == "fp32":
        scale = max(1.0, float(np.abs(r).max()))
        err = float(np.abs(g - r).max())
        assert err <= rtol * scale, (err, scale)
    else:
        assert bf16_ulps(got, ref) <= ulps, bf16_ulps(got, ref)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("k,stride,pad,bias", [(3, 1, 1, True), (7, 2, 3, True),
                                                (1, 1, 0, False), (3, 2, 1, True)])
def test_conv2d(rng, kind, k, stride, pad, bias):
    x = rng.standard_normal((2, 11, 14, 8)).astype(np.float32)
    w = (rng.standard_normal((k, k, 8, 16)) * 0.3).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32) if bias else None
    jx, tx = both(x, kind)
    ref = jx_basic.conv2d(jx, jnp.asarray(w), None if b is None else jnp.asarray(b),
                          stride=stride, padding=pad)
    got = basic.conv2d(tx, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       None if b is None else torch.from_numpy(b),
                       stride=stride, padding=pad)
    assert got.dtype == DTYPES[kind][2]
    # bf16: one rounding of the accumulator, then the bias add rounds again.
    assert_close(got, ref, kind, ulps=2.0)


def test_conv2d_fp32_accumulator_from_bf16(rng):
    """out_dtype=float32 hands back the accumulator of bf16 operands."""
    x = rng.standard_normal((1, 9, 10, 32)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 32, 24)) * 0.2).astype(np.float32)
    jx, tx = both(x, "bf16")
    ref = jx_basic.conv2d(jx, jnp.asarray(w), None, padding=1, out_dtype=jnp.float32)
    got = basic.conv2d(tx, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), None,
                       padding=1, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_frozen_batch_norm(rng, kind):
    x = rng.standard_normal((2, 5, 6, 12)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 12), "bias": rng.standard_normal(12),
         "mean": rng.standard_normal(12), "var": rng.uniform(0.5, 2.0, 12)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jx, tx = both(x, kind)
    ref = jx_basic.frozen_batch_norm(jx, {k: jnp.asarray(v) for k, v in p.items()})
    got = basic.frozen_batch_norm(tx, *(torch.from_numpy(p[k]) for k in
                                        ("scale", "bias", "mean", "var")))
    assert_close(got, ref, kind, ulps=1.0)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_instance_norm(rng, kind):
    """bf16 takes the one-pass variance, fp32 the two-pass one."""
    x = (rng.standard_normal((2, 7, 9, 16)) * 2 + 0.5).astype(np.float32)
    jx, tx = both(x, kind)
    assert_close(basic.instance_norm(tx), jx_basic.instance_norm(jx), kind, ulps=2.0)


def test_group_norm(rng):
    x = rng.standard_normal((2, 6, 5, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    ref = jx_basic.group_norm(jnp.asarray(x), {"scale": jnp.asarray(scale),
                                               "bias": jnp.asarray(bias)}, 4)
    got = basic.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), 4)
    assert_close(got, ref, "fp32")


def test_coords_grid():
    np.testing.assert_array_equal(to_np(coords_grid(2, 5, 7)),
                                  to_np(jx_coords_grid(2, 5, 7)))


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("w", [20, 37])
def test_avg_pool_last(rng, kind, w):
    x = rng.standard_normal((3, 4, w)).astype(np.float32)
    jx, tx = both(x, kind)
    ref, got = jx_pooling.avg_pool_last(jx), pooling.avg_pool_last(tx)
    assert got.shape == ref.shape
    # One fp32 mean of two values, rounded once: exact agreement.
    np.testing.assert_array_equal(to_np(got), to_np(ref))


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("h,w", [(8, 12), (9, 13)])
def test_pool2x(rng, kind, h, w):
    x = rng.standard_normal((2, h, w, 8)).astype(np.float32)
    jx, tx = both(x, kind)
    assert_close(pooling.pool2x(tx), jx_pooling.pool2x(jx), kind, ulps=1.0)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("size", [(12, 20), (7, 9), (6, 10)])
def test_interp_align_corners(rng, kind, size):
    """The banded-matrix form, rounded once per axis in bf16."""
    x = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    jx, tx = both(x, kind)
    ref = jx_resize.interp_align_corners(jx, size)
    got = resize.interp_align_corners(tx, size)
    assert_close(got, ref, kind, ulps=1.0)


@pytest.mark.parametrize("factor", [4, 8])
def test_convex_upsample(rng, factor):
    flow = (rng.standard_normal((2, 5, 6, 1)) * 3).astype(np.float32)
    mask = rng.standard_normal((2, 5, 6, factor * factor * 9)).astype(np.float32)
    ref = jx_upsample.convex_upsample(jnp.asarray(flow), jnp.asarray(mask), factor)
    got = upsample.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask), factor)
    assert_close(got, ref, "fp32")


@pytest.mark.parametrize("mode,bucket", [("sintel", None), ("kitti", None),
                                         ("sintel", 32)])
@pytest.mark.parametrize("hw", [(375, 1242), (40, 64), (33, 50)])
def test_input_padder(rng, mode, bucket, hw):
    x = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    divis = 32 if bucket else 8
    jp = jx_padder.InputPadder(x.shape, mode=mode, divis_by=divis, bucket=bucket)
    tp = InputPadder(x.shape, mode=mode, divis_by=divis, bucket=bucket)
    assert tp.padded_shape == jp.padded_shape
    (jpad,), (tpad,) = jp.pad(jnp.asarray(x)), tp.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(tpad), to_np(jpad))
    np.testing.assert_array_equal(to_np(tp.unpad(tpad)), x)
    if hw == (375, 1242) and bucket:
        assert tp.padded_shape == (384, 1248)


@pytest.mark.parametrize("hw", [(375, 1242), (40, 64), (64, 64), (1, 1)])
@pytest.mark.parametrize("bucket,divis", [(32, 8), (64, 32), (128, 32)])
def test_bucket_shape(hw, bucket, divis):
    assert bucket_shape(hw, bucket, divis) == jx_padder.bucket_shape(hw, bucket, divis)
    assert bucket_shape((2, *hw, 3), bucket, divis) == jx_padder.bucket_shape(
        (2, *hw, 3), bucket, divis)
    with pytest.raises(ValueError):
        bucket_shape(hw, divis + 1, divis)


@pytest.mark.parametrize("factor", [4, 8])
def test_upflow(rng, factor):
    flow = (rng.standard_normal((2, 5, 7, 2)) * 3).astype(np.float32)
    got = upflow(torch.from_numpy(flow), factor)
    assert got.shape == (2, 5 * factor, 7 * factor, 2)
    assert_close(got, jx_upflow(jnp.asarray(flow), factor), "fp32")


@pytest.mark.parametrize("w", [20, 37])
def test_avg_pool_w2(rng, w):
    x = rng.standard_normal((2, 3, w, 8)).astype(np.float32)
    jx, tx = both(x, "fp32")
    got, ref = pooling.avg_pool_w2(tx), jx_pooling.avg_pool_w2(jx)
    assert got.shape == ref.shape == (2, 3, w // 2, 8)
    assert_close(got, ref, "fp32")


@pytest.mark.parametrize("h,w", [(16, 24), (13, 19)])
def test_pool4x(rng, h, w):
    x = rng.standard_normal((2, h, w, 8)).astype(np.float32)
    jx, tx = both(x, "fp32")
    got, ref = pooling.pool4x(tx), jx_pooling.pool4x(jx)
    assert got.shape == ref.shape
    assert_close(got, ref, "fp32")


def _positions(rng, shape, width):
    """Fractional positions over and past both ends of a row, with some on
    the integers and the two ends exactly."""
    x = rng.uniform(-3, width + 2, shape).astype(np.float32)
    x.flat[:4] = [0.0, width - 1, -1.0, 2.0]
    return x


def test_sample_1d_zeros(rng):
    values = rng.standard_normal((2, 5, 23)).astype(np.float32)
    x = _positions(rng, (2, 5, 9), 23)
    got = sampler.sample_1d_zeros(torch.from_numpy(values), torch.from_numpy(x))
    ref = jx_sampler.sample_1d_zeros(jnp.asarray(values), jnp.asarray(x))
    assert got.shape == (2, 5, 9)
    assert_close(got, ref, "fp32")


def test_sample_rows_zeros(rng):
    fmap = rng.standard_normal((2, 5, 23, 16)).astype(np.float32)
    x = _positions(rng, (2, 5, 9), 23)
    got = sampler.sample_rows_zeros(torch.from_numpy(fmap), torch.from_numpy(x))
    ref = jx_sampler.sample_rows_zeros(jnp.asarray(fmap), jnp.asarray(x))
    assert got.shape == (2, 5, 9, 16)
    assert_close(got, ref, "fp32")


@pytest.mark.parametrize("n,chunk,axis", [(10, 4, 0), (12, 4, 1), (3, 8, 0), (7, 3, 2)])
def test_map_chunked(rng, n, chunk, axis):
    """Each chunk sees ``chunk`` rows (the last zero-padded), and only real
    rows come back, in order."""
    shape = [3, 4, 5]
    shape[axis] = n
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    seen = []

    def fn_t(xs):
        seen.append(xs[0].shape[axis])
        return torch.tanh(xs[0]) * xs[1] + 1.0

    got = chunked.map_chunked(fn_t, (torch.from_numpy(a), torch.from_numpy(b)), chunk, axis)
    ref = jx_chunked.map_chunked(lambda xs: jnp.tanh(xs[0]) * xs[1] + 1.0,
                                 (jnp.asarray(a), jnp.asarray(b)), chunk, axis)
    assert got.shape == tuple(shape)
    assert_close(got, ref, "fp32")
    assert set(seen) == {min(n, chunk)} and len(seen) == -(-n // chunk)


def test_ops_exports_cover_the_jax_package():
    assert set(jx_ops.__all__) <= set(port_ops.__all__)
    assert {"bucket_shape", "map_chunked"} <= set(port_ops.__all__)
    assert all(callable(getattr(port_ops, name)) for name in port_ops.__all__)


def _jax_params_to_module(module: torch.nn.Module, fill) -> None:
    """Load a JAX sub-pytree into ``module`` through the port's transplant:
    ``fill(out)`` writes the reference keys under the prefix ``m``."""
    out = {}
    fill(out)
    module.load_state_dict({k[2:]: v for k, v in out.items()}, strict=True)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("norm_fn", ["batch", "instance", "group", "none"])
@pytest.mark.parametrize("stride,cin", [(1, 32), (2, 16)])
def test_residual_block(rng, kind, norm_fn, stride, cin):
    p = jx_layers.init_residual_block(jax.random.PRNGKey(3), cin, 32, norm_fn, stride)
    if norm_fn == "batch":  # non-trivial running statistics
        for key in ("norm1", "norm2"):
            p[key]["mean"] = jnp.asarray(rng.standard_normal(32), jnp.float32) * 0.1
            p[key]["var"] = jnp.asarray(rng.uniform(0.5, 2.0, 32), jnp.float32)
    blk = ResidualBlock(cin, 32, norm_fn, stride=stride)
    _jax_params_to_module(blk, lambda out: transplant._residual_block(out, "m", p, norm_fn))
    x = rng.standard_normal((2, 8, 10, cin)).astype(np.float32)
    jx, tx = both(x, kind)
    ref = jx_layers.apply_residual_block(p, jx, norm_fn, stride=stride)
    with torch.no_grad():
        got = blk(tx)
    if kind == "fp32":
        assert_close(got, ref, kind, rtol=1e-4)
    else:
        # A chain of rounded bf16 ops: compare against the output's scale.
        err = float(np.abs(to_np(got) - to_np(ref)).max())
        assert err <= 0.05 * max(1.0, float(np.abs(to_np(ref)).max())), err


def test_encoders_fp32(rng):
    """BasicEncoder (instance) and MultiBasicEncoder (batch) against the JAX
    encoders on their unfused path, fp32, n_downsample 2."""
    kf, kc = jax.random.split(jax.random.PRNGKey(5))
    pf = jx_extractor.init_basic_encoder(kf, output_dim=64, norm_fn="instance",
                                         downsample=2)
    pc = jx_extractor.init_multi_basic_encoder(kc, output_dim=[[32] * 3, [32] * 3],
                                               norm_fn="batch", downsample=2)
    fnet = BasicEncoder(output_dim=64, norm_fn="instance", downsample=2)
    cnet = MultiBasicEncoder(output_dim=[[32] * 3, [32] * 3], norm_fn="batch", downsample=2)

    def fill_basic(out):
        transplant._trunk(out, "m", pf, "instance", ("layer1", "layer2", "layer3"))
        transplant._conv(out, "m.conv2", pf["conv2"])

    def fill_multi(out):
        transplant._trunk(out, "m", pc, "batch",
                          ("layer1", "layer2", "layer3", "layer4", "layer5"))
        for scale in ("outputs08", "outputs16"):
            for j, head in enumerate(pc[scale]):
                transplant._residual_block(out, f"m.{scale}.{j}.0", head["res"], "batch")
                transplant._conv(out, f"m.{scale}.{j}.1", head["conv"])
        for j, head in enumerate(pc["outputs32"]):
            transplant._conv(out, f"m.outputs32.{j}", head["conv"])

    _jax_params_to_module(fnet, fill_basic)
    _jax_params_to_module(cnet, fill_multi)
    x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    jx, tx = both(x, "fp32")
    with torch.no_grad():
        assert_close(fnet(tx), jx_extractor.apply_basic_encoder(
            pf, jx, norm_fn="instance", downsample=2, fused=False), "fp32", rtol=1e-4)
        got = cnet(tx[:1], num_layers=3)
    ref = jx_extractor.apply_multi_basic_encoder(pc, jx[:1], norm_fn="batch", downsample=2,
                                                 num_layers=3, fused=False)
    for glist, rlist in zip(got, ref):
        for g, r in zip(glist, rlist):
            assert_close(g, r, "fp32", rtol=1e-4)
