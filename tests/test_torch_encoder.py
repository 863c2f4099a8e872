"""The port's fused encoders (``ops/encoder.py``, ``models/extractor.py``)
against the JAX package's (``ops/pallas_encoder.py``, Pallas kernels in
interpret mode on the CPU), on the same inputs and weights from a seed.

On the CPU each wrapper runs its plain version, which rounds where the CUDA
kernel and the Pallas kernel do, so these tests hold the fused route, not the
plain modules, against JAX.

Tolerances. fp32: 1e-4 absolute (both sides fold BatchNorm and take the same
statistics; only the summation order differs). bf16, in bf16 ulps of the
reference (``_ulps``: an element's ulp, floored at the ulp of the map's RMS
so that values near zero are held to the map's scale): a single pass may land
on the other side of one rounding where the fp32 sums differ in their last
bits, so 1 ulp; the chains carry such a flip through up to five convolutions
and two or three exits, so 8 ulps at most and under 10% of the elements
different at all (they come out at 2-3 ulps and 0.3-2%); a whole encoder,
whose plain stride-2 blocks and norms round at other places than XLA's fused
elementwise code, 16 ulps (3-6 seen). Statistics: 1e-5 relative to the
largest entry (fp32 sums in another order). End to end, the serving canary
band (rtol 5e-3, atol 5e-2 px) with the flow head tempered as in
test_torch_model.py.

tests/test_torch_gpu.py holds the CUDA kernels against the plain versions on
the card.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raft_stereo_tpu.models.raft_stereo as jx_model
import raft_stereo_tpu.ops.pallas_encoder as jx_pe
import raft_stereo_tpu.ops.pallas_stream as jx_ps
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import init_raft_stereo as jx_init
from raft_stereo_tpu.models import raft_stereo_forward as jx_forward
from raft_stereo_tpu.models.extractor import (
    apply_basic_encoder, apply_multi_basic_encoder, init_basic_encoder,
    init_multi_basic_encoder)
from raft_stereo_tpu.models.layers import init_conv, init_residual_block

import raft_stereo_tpu_torch.models.raft_stereo as port_model
from raft_stereo_tpu_torch import RAFTStereo, RAFTStereoConfig, raft_stereo_forward, transplant
from raft_stereo_tpu_torch.config import fused_encoders_on, stream_tail_on
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.models.layers import Conv2d, ResidualBlock
from raft_stereo_tpu_torch.ops import encoder as enc
from raft_stereo_tpu_torch.transplant import load_state_dict, params_from_jax

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
SMALL = dict(hidden_dims=(32, 32, 32))
CANARY = dict(rtol=5e-3, atol=5e-2)
PASS_ULPS, CHAIN_ULPS, CHAIN_SHARE = 1.0, 8.0, 0.10


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The parallel test runner puts several worker processes on one CPU;
    a small intra-op pool keeps these tests from starving the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ulps(got, ref) -> np.ndarray:
    """|got - ref| in bf16 ulps of the reference, an element's magnitude
    floored at the map's RMS."""
    got, ref = _np(got), _np(ref)
    mag = np.maximum(np.abs(ref), max(float(np.sqrt(np.mean(ref ** 2))), 1e-6))
    return np.abs(got - ref) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def _hold(kind, got, ref, ulps, share=None):
    assert tuple(got.shape) == tuple(ref.shape)
    if kind == "fp32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-4)
        return
    u = _ulps(got, ref)
    assert u.max() <= ulps, (u.max(), float((u > 0).mean()))
    if share is not None:
        assert float((u > 0).mean()) <= share, float((u > 0).mean())


def _hold_stats(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _both(kind, a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[kind]), torch.from_numpy(a).to(TDT[kind])


def _load(module, fill):
    """Fill ``module`` from JAX parameters through the transplant's own
    converters: ``fill(out)`` writes reference-layout keys under ``m.``."""
    out = {}
    fill(out)
    module.load_state_dict({k[2:]: v for k, v in out.items()}, strict=True)
    return module.eval()


def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _randomize_bn(p, rng):
    """Frozen-BN statistics away from the identity, so the fold matters."""
    if isinstance(p, dict):
        if set(p) == {"scale", "bias", "mean", "var"}:
            c = p["scale"].shape[0]
            return {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
                    "bias": jnp.asarray(rng.normal(0, 0.2, c), jnp.float32),
                    "mean": jnp.asarray(rng.normal(0, 0.2, c), jnp.float32),
                    "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)}
        return {k: _randomize_bn(v, rng) for k, v in p.items()}
    if isinstance(p, list):
        return [_randomize_bn(v, rng) for v in p]
    return p


def _cnet(rng, dims=((32, 32, 32), (32, 32, 32))):
    p = _randomize_bn(init_multi_basic_encoder(
        jax.random.PRNGKey(0), output_dim=[list(d) for d in dims], norm_fn="batch",
        downsample=2), rng)
    np_p = _np_tree(p)

    def fill(out):
        transplant._trunk(out, "m", np_p, "batch",
                          ("layer1", "layer2", "layer3", "layer4", "layer5"))
        for scale in ("outputs08", "outputs16"):
            for j, head in enumerate(np_p[scale]):
                transplant._residual_block(out, f"m.{scale}.{j}.0", head["res"], "batch")
                transplant._conv(out, f"m.{scale}.{j}.1", head["conv"])
        for j, head in enumerate(np_p["outputs32"]):
            transplant._conv(out, f"m.outputs32.{j}", head["conv"])

    return p, _load(MultiBasicEncoder(dims, "batch", 2), fill)


def _fnet():
    p = init_basic_encoder(jax.random.PRNGKey(1), output_dim=64, norm_fn="instance",
                           downsample=2)
    np_p = _np_tree(p)

    def fill(out):
        transplant._trunk(out, "m", np_p, "instance", ("layer1", "layer2", "layer3"))
        transplant._conv(out, "m.conv2", np_p["conv2"])

    return p, _load(BasicEncoder(64, "instance", 2), fill)


# -- each function against the Pallas pass -------------------------------------


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("stats", [False, True])
def test_stem_matches_pallas(rng, kind, stats):
    hh, ww = 16, 24
    pc = init_conv(jax.random.PRNGKey(2), 7, 7, 3, 64)
    jx, tx = _both(kind, rng.uniform(-1, 1, (1, hh, ww, 3)))
    packed, jst = jx_pe._run_stem(jx_pe.stem_halves(jx), jx_pe._stem_weights(pc["w"], JDT[kind]),
                                  jx_pe._pack_bias(pc["b"]), hh, ww // 2, JDT[kind], stats)
    conv = _load(Conv2d(3, 64, 7, padding=3), lambda out: transplant._conv(out, "m", _np_tree(pc)))
    with torch.no_grad():
        got, st = enc.stem(tx, conv.weight, conv.bias, stats=stats)
    assert got.dtype == TDT[kind]
    _hold(kind, got, jx_pe._unpack_exit(packed), PASS_ULPS)
    if stats:
        _hold_stats(st, jx_pe._unpack_stats(jst))
    else:
        assert st is None and jst is None


@pytest.mark.parametrize("hh,ww", [(16, 24), (8, 70)])
def test_stem_layout_as_a_gemm_matches_plain_and_pallas(rng, hh, ww):
    """The stem kernel's weight layout (``_stem_layout``: K dy-major, 22 a
    tap row dy, 160 in all) applied as one GEMM to an im2col of the image in
    the same K order, in fp32 with one rounding as the kernel sums, against
    ``stem_plain`` and JAX's ``_run_stem`` (bf16, one ulp): a slip in the
    layout fails here, not only on the card."""
    pc = init_conv(jax.random.PRNGKey(3), 7, 7, 3, 64)
    jx, tx = _both("bf16", rng.uniform(-1, 1, (1, hh, ww, 3)))
    conv = _load(Conv2d(3, 64, 7, padding=3), lambda out: transplant._conv(out, "m", _np_tree(pc)))
    wk, b = enc._stem_layout(conv.weight.detach(), conv.bias.detach(), torch.device("cpu"))
    assert tuple(wk.shape) == (64, enc._STEM_K) and wk.dtype == torch.bfloat16
    xp = torch.nn.functional.pad(tx.float(), (0, 0, 3, 3, 3, 3))[0]
    cols = torch.zeros((hh, ww, enc._STEM_K))
    for dy in range(7):
        for dx in range(7):
            k = dy * enc._STEM_TAP_ROW + 3 * dx
            cols[:, :, k:k + 3] = xp[dy:dy + hh, dx:dx + ww]
    got = (cols.reshape(hh * ww, -1) @ wk.float().T + b).reshape(1, hh, ww, 64).bfloat16()
    with torch.no_grad():
        plain, _ = enc.stem_plain(tx, conv.weight, conv.bias, stats=False)
    packed, _ = jx_pe._run_stem(jx_pe.stem_halves(jx), jx_pe._stem_weights(pc["w"], JDT["bf16"]),
                                jx_pe._pack_bias(pc["b"]), hh, ww // 2, JDT["bf16"], False)
    _hold("bf16", got, plain, PASS_ULPS)
    _hold("bf16", got, jx_pe._unpack_exit(packed), PASS_ULPS)


def _mv(rng, c):
    return (rng.normal(0, 0.3, c).astype(np.float32),
            rng.uniform(0.5, 2.0, c).astype(np.float32))


def _triples(rng, kind, n, shape, with_mv):
    """n (raw, mean, inv) inputs on both sides; the JAX side as (H, W, C)
    maps with (1, C) rows, as ``_run_pass`` takes them."""
    jxs, txs = [], []
    for _ in range(n):
        jraw, traw = _both(kind, rng.standard_normal(shape))
        if with_mv:
            m, v = _mv(rng, shape[-1])
            jxs.append((jraw[0], jnp.asarray(m)[None], jnp.asarray(v)[None]))
            txs.append((traw, torch.from_numpy(m), torch.from_numpy(v)))
        else:
            jxs.append((jraw[0], None, None))
            txs.append((traw, None, None))
    return jxs, txs


def _jx_pass(kind_name, jxs, pc, hh, ww, kind, stats, ch):
    """``_run_pass`` in the plain (H, W, C) layout of the tail; the mid
    kinds take identity rows where BatchNorm is folded, as the chains pass."""
    if kind_name != "raw1" and not stats:
        jxs = [(raw, *jx_pe._ident_mv(ch)) for raw, _, _ in jxs]
    out, st = jx_pe._run_pass(kind_name, jxs, pc["w"].astype(JDT[kind]),
                              jx_pe._bias_row(pc.get("b"), pc["w"].shape[-1]), hh, ww,
                              jx_pe._strip_cols(ww), JDT[kind], stats)
    return out[:hh][None], st


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("kind_name,ch", [("raw1", 96), ("mid1", 128), ("mid2", 64)])
def test_conv_pass_matches_pallas(rng, kind, stats, kind_name, ch):
    hh, ww = 16, 24
    pc = init_conv(jax.random.PRNGKey(3), 3, 3, ch, ch)
    jxs, txs = _triples(rng, kind, 2 if kind_name == "mid2" else 1, (1, hh, ww, ch),
                        with_mv=stats and kind_name != "raw1")
    ref, jst = _jx_pass(kind_name, jxs, pc, hh, ww, kind, stats, ch)
    conv = _load(Conv2d(ch, ch, 3, padding=1),
                 lambda out: transplant._conv(out, "m", _np_tree(pc)))
    with torch.no_grad():
        got, st = enc.conv_pass(kind_name, txs, conv.weight, conv.bias, stats=stats)
    assert got.dtype == TDT[kind]
    _hold(kind, got, ref, PASS_ULPS)
    if stats:
        _hold_stats(st, jst)
    else:
        assert st is None


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_conv_pass_without_a_bias(rng, kind):
    """A missing bias is a row of zeros (``_bias_row``)."""
    hh, ww, ch = 8, 16, 32
    pc = {"w": init_conv(jax.random.PRNGKey(4), 3, 3, ch, 64)["w"]}
    jxs, txs = _triples(rng, kind, 1, (1, hh, ww, ch), with_mv=False)
    ref, _ = _jx_pass("raw1", jxs, pc, hh, ww, kind, False, ch)
    w = torch.from_numpy(np.asarray(pc["w"], np.float32).transpose(3, 2, 0, 1).copy())
    got, _ = enc.conv_pass("raw1", txs, w, None, stats=False)
    _hold(kind, got, ref, PASS_ULPS)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_zero_padding_comes_after_the_transform(rng, kind):
    """With a large negative mean, relu((0 - mean) * inv) is far from 0: a
    pass that padded before transforming would add it at every border tap."""
    hh, ww, ch = 8, 16, 32
    pc = init_conv(jax.random.PRNGKey(5), 3, 3, ch, ch)
    jraw, traw = _both(kind, rng.standard_normal((1, hh, ww, ch)))
    m = np.full(ch, -40.0, np.float32)
    v = np.full(ch, 0.5, np.float32)
    ref, _ = _jx_pass("mid1", [(jraw[0], jnp.asarray(m)[None], jnp.asarray(v)[None])], pc, hh, ww,
                      kind, True, ch)
    conv = _load(Conv2d(ch, ch, 3, padding=1),
                 lambda out: transplant._conv(out, "m", _np_tree(pc)))
    with torch.no_grad():
        got, _ = enc.conv_pass("mid1", [(traw, torch.from_numpy(m), torch.from_numpy(v))],
                               conv.weight, conv.bias, stats=True)
        # The mistake this guards against: zero-pad the raw map, then transform.
        wrong = torch.nn.functional.conv2d(
            enc._normed(torch.nn.functional.pad(traw, (0, 0, 1, 1, 1, 1)), torch.from_numpy(m),
                        torch.from_numpy(v)).float().permute(0, 3, 1, 2),
            conv.weight.to(TDT[kind]).float(), conv.bias, 1, 0).permute(0, 2, 3, 1)
    _hold(kind, got, ref, PASS_ULPS)
    assert np.abs(_np(wrong) - _np(ref))[0, 0].max() > 1.0  # whole units off along the border
    assert np.abs(_np(wrong) - _np(ref))[0, 2:-2, 2:-2].max() <= np.abs(_np(ref)).max() * 2.0 ** -6


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("norm", [False, True])
def test_point3_matches_pallas(rng, kind, norm):
    hh, ww, ch = 16, 24, 64
    jxs, txs = _triples(rng, kind, 3, (1, hh, ww, ch), with_mv=True)
    ref = jx_pe._run_pass("point3", jxs, None, None, hh, ww, jx_pe._strip_cols(ww), JDT[kind],
                          False, norm=norm)
    got = enc.point3(*txs, norm=norm)
    _hold(kind, got, ref[None], PASS_ULPS)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("norm", [False, True])
def test_point2_matches_pallas(rng, kind, norm):
    hh, ww, ch = 16, 24, 96
    (jx, jy), (tx, ty) = _triples(rng, kind, 2, (1, hh, ww, ch), with_mv=True)
    ref = jx_pe._run_pass("point2", [(jx[0], None, None), jy], None, None, hh, ww,
                          jx_pe._strip_cols(ww), JDT[kind], False, norm=norm)
    got = enc.point2(tx[0], ty, norm=norm)
    _hold(kind, got, ref[None], PASS_ULPS)


def test_fold_bn_and_stats_to_mv_match_jax(rng):
    p = _randomize_bn(init_residual_block(jax.random.PRNGKey(6), 64, 64, "batch", 1), rng)
    block = _load(ResidualBlock(64, 64, "batch", 1),
                  lambda out: transplant._residual_block(out, "m", _np_tree(p), "batch"))
    ref_w, ref_b = jx_pe._fold_bn(p["conv1"], p["norm1"])
    with torch.no_grad():
        w, b = enc.fold_bn(block.conv1, block.norm1)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w).transpose(3, 2, 0, 1), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref_b), rtol=1e-6, atol=1e-7)
    st = np.stack([rng.normal(0, 50, 64), rng.uniform(400, 900, 64)]).astype(np.float32)
    ref_m, ref_v = jx_pe._stats_to_mv(jnp.asarray(st), 384)
    m, v = enc.stats_to_mv(torch.from_numpy(st), 384)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m)[0], rtol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v)[0], rtol=1e-5)


# -- the chains -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("hw", [(48, 24), (16, 800)])
def test_fused_stem_layer1_matches_pallas(rng, kind, hw):
    p, model = _cnet(rng)
    jx, tx = _both(kind, rng.uniform(-1, 1, (1, *hw, 3)))
    ref = jx_pe.fused_stem_layer1_impl(p, jx)
    with torch.no_grad():
        got = enc.fused_stem_layer1(model, tx)
    assert got.dtype == TDT[kind]
    _hold(kind, got, ref, CHAIN_ULPS, CHAIN_SHARE)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("hw", [(48, 24), (16, 800)])
def test_fused_in_stem_layer1_matches_pallas(rng, kind, hw):
    p, model = _fnet()
    jx, tx = _both(kind, rng.uniform(-1, 1, (1, *hw, 3)))
    ref = jx_pe.fused_in_stem_layer1_impl(p, jx)
    with torch.no_grad():
        got = enc.fused_in_stem_layer1(model, tx)
    _hold(kind, got, ref, CHAIN_ULPS, CHAIN_SHARE)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("norm_fn,ch", [("instance", 96), ("instance", 128), ("batch", 96),
                                        ("batch", 128)])
def test_stream_resblock_matches_pallas(rng, monkeypatch, kind, norm_fn, ch):
    monkeypatch.setattr(jx_ps, "FORCE_FUSABLE_DTYPE", True)
    p = init_residual_block(jax.random.PRNGKey(7), ch, ch, norm_fn, stride=1)
    if norm_fn == "batch":
        p = _randomize_bn(p, rng)
    jx, tx = _both(kind, rng.standard_normal((1, 16, 24, ch)))
    assert jx_pe.resblock_streamable(p, jx, norm_fn)
    ref = jx_pe.stream_resblock(norm_fn, p, jx)
    block = _load(ResidualBlock(ch, ch, norm_fn, 1),
                  lambda out: transplant._residual_block(out, "m", _np_tree(p), norm_fn))
    with torch.no_grad():
        got = enc.stream_resblock(block, tx, norm_fn)
    _hold(kind, got, ref, CHAIN_ULPS, CHAIN_SHARE)
    assert enc.resblock_streamable(block, tx, norm_fn) == (kind == "bf16")


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_stream_head_conv_matches_pallas(rng, monkeypatch, kind):
    monkeypatch.setattr(jx_ps, "FORCE_FUSABLE_DTYPE", True)
    pc = init_conv(jax.random.PRNGKey(8), 3, 3, 128, 64)
    jx, tx = _both(kind, rng.standard_normal((1, 24, 40, 128)))
    assert jx_pe.head_conv_streamable(pc, jx)
    ref = jx_pe.stream_head_conv(pc, jx)
    conv = _load(Conv2d(128, 64, 3, padding=1),
                 lambda out: transplant._conv(out, "m", _np_tree(pc)))
    with torch.no_grad():
        got = enc.stream_head_conv(conv, tx)
    _hold(kind, got, ref, PASS_ULPS)
    assert enc.head_conv_streamable(conv, tx) == (kind == "bf16")


# -- the encoders, end to end ------------------------------------------------------


def _count(monkeypatch, calls, module, name):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


def _port_counts(monkeypatch) -> dict:
    calls = {}
    for name in ("stem", "conv_pass", "point3", "point2"):
        _count(monkeypatch, calls, enc, name)
    return calls


def test_context_encoder_matches_jax_fused(rng, monkeypatch):
    """bf16, (1, 48, 24, 3): the JAX package's fused route (trunk, tail and
    finest heads through its kernels) against the port's. One frame makes
    1 stem, 14 passes (4 trunk, 2 each for layer2[1] and layer3[1], 3 for
    each of the two finest heads), 1 point3 and 4 point2 calls."""
    p, model = _cnet(rng)
    jx, tx = _both("bf16", rng.uniform(-1, 1, (1, 48, 24, 3)))
    jcalls = {}
    for name in ("_run_stem", "_run_pass"):
        _count(monkeypatch, jcalls, jx_pe, name)
    ref = apply_multi_basic_encoder(p, jx, norm_fn="batch", downsample=2, num_layers=3, fused=True)
    assert jcalls == {"_run_stem": 1, "_run_pass": 4 + 1 + 3 * 2 + 2 * 4}, jcalls
    calls = _port_counts(monkeypatch)
    with torch.no_grad():
        got = model(tx, num_layers=3)
    assert calls == {"stem": 1, "conv_pass": 14, "point3": 1, "point2": 4}, calls
    for level, ref_level in zip(got, ref):
        for g, r in zip(level, ref_level):
            _hold("bf16", g, r, 2 * CHAIN_ULPS)


def test_feature_encoder_matches_jax_fused(rng, monkeypatch):
    p, model = _fnet()
    jx, tx = _both("bf16", rng.uniform(-1, 1, (1, 48, 24, 3)))
    ref = apply_basic_encoder(p, jx, norm_fn="instance", downsample=2, fused=True)
    calls = _port_counts(monkeypatch)
    with torch.no_grad():
        got = model(tx)
    assert calls == {"stem": 1, "conv_pass": 8, "point3": 1, "point2": 2}, calls
    _hold("bf16", got, ref, 2 * CHAIN_ULPS)


def _unfused_context(model, x):
    """The context encoder as plain modules: what ``RAFT_FUSED_ENCODERS=0``
    must reproduce bit for bit."""
    y = model.layer3(model.layer2(model.layer1(torch.relu(model.norm1(model.conv1(x))))))
    out = [[head(y) for head in model.outputs08]]
    y = model.layer4(y)
    out.append([head(y) for head in model.outputs16])
    out.append([head(model.layer5(y)) for head in model.outputs32])
    return out


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_switches_route_the_encoders(rng, monkeypatch, kind):
    """Both on: the whole fused route (bf16 only; fp32 runs the plain
    modules whatever the switches say). ``RAFT_STREAM_TAIL=0``: only the
    trunk. ``RAFT_FUSED_ENCODERS=0``: no encoder kernel, and the plain
    modules' bits."""
    _, model = _cnet(rng)
    _, tx = _both(kind, rng.uniform(-1, 1, (1, 32, 32, 3)))
    fused = kind == "bf16"
    expect = {
        ("1", "1"): {"stem": 1, "conv_pass": 14, "point3": 1, "point2": 4} if fused else {},
        ("1", "0"): {"stem": 1, "conv_pass": 4, "point3": 1} if fused else {},
        ("0", "1"): {},
    }
    for (enc_on, tail_on), want in expect.items():
        monkeypatch.setenv("RAFT_FUSED_ENCODERS", enc_on)
        monkeypatch.setenv("RAFT_STREAM_TAIL", tail_on)
        with monkeypatch.context() as m, torch.no_grad():
            calls = _port_counts(m)
            got = model(tx, num_layers=3)
        assert calls == want, (enc_on, tail_on, calls)
        if not want:
            with torch.no_grad():
                plain = _unfused_context(model, tx)
            for level, plain_level in zip(got, plain):
                for g, r in zip(level, plain_level):
                    assert torch.equal(g, r)


def test_launch_counts_by_variant_stay_zero_on_the_cpu(rng):
    """A wrapper counts where it launches its kernel and nowhere else: the
    fused route on CPU tensors runs the plain versions and counts nothing.
    ``count_launch`` adds to both books, ``reset_launches`` clears both."""
    from raft_stereo_tpu_torch import kernels
    _, model = _cnet(rng)
    _, tx = _both("bf16", rng.uniform(-1, 1, (1, 16, 16, 3)))
    kernels.reset_launches()
    with torch.no_grad():
        model(tx)
    assert not kernels.launches and not kernels.variants
    kernels.count_launch("enc_pass", "mid1/instance/64")
    kernels.count_launch("enc_pass", "raw1/bn/96")
    assert kernels.launches == {"enc_pass": 2}
    assert kernels.variants == {"enc_pass:mid1/instance/64": 1, "enc_pass:raw1/bn/96": 1}
    kernels.reset_launches()
    assert not kernels.launches and not kernels.variants


def test_gates_follow_the_jax_values_rules(rng):
    """B > 1, a strided stem and a projection shortcut keep the plain route;
    shapes the JAX package turns away for its compiler's sake do not."""
    _, cnet = _cnet(rng)
    _, fnet = _fnet()
    x = torch.zeros((1, 7, 13, 3), dtype=torch.bfloat16)  # odd, under the JAX kernels' 16 rows
    assert enc.stem_layer1_is_fusable(cnet, x, "batch", 1)
    assert enc.in_stem_layer1_is_fusable(fnet, x, "instance", 1)
    assert not enc.stem_layer1_is_fusable(cnet, x, "instance", 1)
    assert not enc.in_stem_layer1_is_fusable(fnet, x, "batch", 1)
    assert not enc.stem_layer1_is_fusable(cnet, x, "batch", 2)
    assert not enc.stem_layer1_is_fusable(cnet, x.float(), "batch", 1)
    assert not enc.stem_layer1_is_fusable(cnet, x.repeat(2, 1, 1, 1), "batch", 1)
    y = torch.zeros((1, 3, 5, 96), dtype=torch.bfloat16)
    assert enc.resblock_streamable(cnet.layer2[1], y, "batch")
    assert not enc.resblock_streamable(cnet.layer2[1], y, "group")
    assert not enc.resblock_streamable(cnet.layer2[1], y.repeat(2, 1, 1, 1), "batch")
    assert not enc.resblock_streamable(cnet.layer2[0], y[..., :64].contiguous(), "batch")
    z = torch.zeros((1, 3, 5, 128), dtype=torch.bfloat16)
    assert enc.head_conv_streamable(cnet.outputs08[0][1], z)
    assert not enc.head_conv_streamable(cnet.outputs08[0][1], z.float())
    assert not enc.head_conv_streamable(fnet.conv2, z)  # 1x1


@pytest.mark.parametrize("value", [None, "1", "0", "false", "No"])
def test_encoder_switches_parse_like_the_jax_knobs(monkeypatch, value):
    for knob in ("RAFT_FUSED_ENCODERS", "RAFT_STREAM_TAIL"):
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
    assert fused_encoders_on() == jx_pe.ENABLE()
    assert stream_tail_on() == jx_pe._tail_enabled()


def test_a_reloaded_state_dict_leaves_no_stale_fold(rng):
    """The fold is computed from the module when called: after new weights
    are loaded the fused route follows them."""
    _, model = _cnet(rng)
    _, other = _cnet(np.random.default_rng(1))
    _, tx = _both("bf16", rng.uniform(-1, 1, (1, 16, 16, 3)))
    with torch.no_grad():
        before = model(tx)[0][0]
        model.load_state_dict(other.state_dict())
        after, want = model(tx)[0][0], other(tx)[0][0]
    assert torch.equal(after, want) and not torch.equal(after, before)


def test_encoder_weights_are_prepared_once_and_follow_changes(rng):
    """The chains fold and cast a conv's weights once per model and lay them
    out once per kernel and device: a second call reuses the prepared
    tensors. Changing a BatchNorm buffer in place or loading a state dict
    prepares them again, and the fused route's output follows, as the plain
    modules' does."""
    _, model = _cnet(rng)
    _, other = _cnet(np.random.default_rng(1))
    conv, bn = model.layer1[0].conv1, model.layer1[0].norm1
    with torch.no_grad():
        first = enc.module_weights(conv, bn)
        assert enc.module_weights(conv, bn) is first
    # In grad mode they are built afresh, differentiably, and not kept.
    fresh = enc.module_weights(conv, bn)
    assert fresh is not first and fresh.w.requires_grad
    assert torch.equal(fresh.w, first.w) and torch.equal(fresh.b, first.b)
    made = []
    for _ in range(2):
        first.layout("probe", torch.device("cpu"), lambda w, b, dev: made.append(1) or w)
    assert made == [1]
    _, tx = _both("bf16", rng.uniform(-1, 1, (1, 16, 16, 3)))
    with torch.no_grad():
        before, plain_before = model(tx)[0][0], _unfused_context(model, tx)[0][0]
        assert torch.equal(model(tx)[0][0], before)
        bn.running_mean.add_(0.25)
        moved = enc.module_weights(conv, bn)
        assert moved is not first
        for got, want in zip((moved.w, moved.b), enc.fold_bn(conv, bn)):
            assert torch.equal(got, want)
        after = model(tx)[0][0]
        assert not torch.equal(after, before)
        assert not torch.equal(_unfused_context(model, tx)[0][0], plain_before)
        assert torch.equal(after, copy.deepcopy(model)(tx)[0][0])  # a twin prepares afresh
        model.load_state_dict(other.state_dict())
        assert enc.module_weights(conv, bn) is not moved
        assert torch.equal(model(tx)[0][0], other(tx)[0][0])


# -- the whole forward ---------------------------------------------------------------


def _temper(params):
    conv2 = params["update_block"]["flow_head"]["conv2"]
    conv2["w"], conv2["b"] = conv2["w"] * 0.02, conv2["b"] * 0.02
    return params


def _port_from_jax(params, cfg_kw) -> RAFTStereo:
    cfg = RAFTStereoConfig(**cfg_kw)
    model = RAFTStereo(cfg)
    load_state_dict(model, params_from_jax(_np_tree(params), cfg))
    return model.eval()


@pytest.mark.parametrize("sequential_fnet", [False, True])
def test_bf16_forward_matches_jax_defaults(rng, monkeypatch, sequential_fnet):
    """Every switch at its default on both sides. At 64x128 the JAX
    package's gates engage its context-net kernels; with the sequential
    feature net forced (as at Middlebury-F) also the feature net's, twice."""
    for knob in ("RAFT_FUSED_ENCODERS", "RAFT_STREAM_TAIL", "RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        monkeypatch.delenv(knob, raising=False)
    if sequential_fnet:
        monkeypatch.setattr(jx_model, "FNET_SEQUENTIAL_MIN_PIXELS", 0)
        monkeypatch.setattr(port_model, "FNET_SEQUENTIAL_MIN_PIXELS", 0)
    jcalls = {}
    for name in ("_run_stem", "_run_pass"):
        _count(monkeypatch, jcalls, jx_pe, name)
    kw = dict(SMALL, corr_implementation="reg_tpu", mixed_precision=True)
    params = _temper(jx_init(jax.random.PRNGKey(9), JaxConfig(**kw)))
    i1, i2 = (rng.uniform(0, 255, (1, 64, 128, 3)).astype(np.float32) for _ in range(2))
    # Jitted: traced once (the kernel calls are counted at the trace), and
    # twice as fast as the eager interpreter on the CPU.
    ref_lo, ref_up = jax.jit(lambda p, a, b: jx_forward(p, JaxConfig(**kw), a, b, iters=3,
                                                        test_mode=True))(
        params, jnp.asarray(i1), jnp.asarray(i2))
    # lax.map traces the feature net once for both images.
    nets = 2 if sequential_fnet else 1
    assert jcalls["_run_stem"] == nets and jcalls["_run_pass"] >= 19, jcalls
    calls = _port_counts(monkeypatch)
    model = _port_from_jax(params, dict(kw, corr_implementation="reg_cuda"))
    lo, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    want = {"stem": 1, "conv_pass": 14, "point3": 1, "point2": 4}
    if sequential_fnet:
        want = {"stem": 3, "conv_pass": 30, "point3": 3, "point2": 8}
    assert calls == want, calls
    np.testing.assert_allclose(up.numpy(), np.asarray(ref_up, np.float32), **CANARY)
    np.testing.assert_allclose(lo.numpy(), np.asarray(ref_lo, np.float32), **CANARY)
