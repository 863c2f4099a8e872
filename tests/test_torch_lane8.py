"""``RAFT_LANE_PACK8`` in the port: the int8 context lanes, against the JAX
package with the same switch (``feature_scale8``, ``quantize_pack_feature8``,
``prepare_gru_context_any``, the lane8 GRU, gru16+32 and resident kernels
and the q8 encoder exits, Pallas in interpret mode on the CPU).

On the CPU each wrapper runs its plain version, which adds ``q * scale``
(the fp32 product, then the sum) where the bf16 mode adds the bf16 czrq.
The JAX package's width-group fp32 container is unpacked to plain int8
values (byte ``b`` of lane column ``j`` is width position ``b * Wq + j``)
before it is compared.

Tolerances:
- quantization: the int8 values and the scales equal the JAX package's bit
  for bit (same fp32 division, round half to even, clip), for fp32 and bf16
  inputs; a batch row equals the same sample quantized alone; zero rows stay
  exact zeros;
- the lane8 modules: the bf16 mode's tolerance of test_torch_stream.py and
  test_torch_resident.py (2^-5 of the output's scale: convolutions summed in
  another order put a bf16 rounding of z, r, q or f1 one ulp apart) plus one
  bf16 ulp of that scale, because the JAX package's XLA code may contract
  ``q * scale`` into the accumulating add (a few fp32 ulps, which can move
  one bf16 rounding);
- the q8 exits: with integer inputs and weights every sum is exact, so the
  int8 values and the scale equal the JAX package's bit for bit (the
  residual block under a BatchNorm that folds to the identity, since
  instance norm's statistics would make the second conv's sums inexact);
  with normal inputs q may differ by one step where the bf16 exits differ
  (by at most ``|dv| / scale + 1`` steps), and the scale by at most the
  largest difference of the exits over 127 (one bf16 ulp of the amax for one
  pass);
- the model: the serving canary band (rtol 5e-3, atol 5e-2 px) of the JAX
  package's forward with the switch on, the flow head tempered as in
  test_torch_model.py; k segments equal one segment bit for bit, and the
  switch unset equals ``"0"`` bit for bit.

tests/test_torch_gpu.py holds the CUDA kernels' int8 modes against their
plain versions and the serial chains on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raft_stereo_tpu.ops.pallas_encoder as jx_pe
import raft_stereo_tpu.ops.pallas_resident as jx_pr
import raft_stereo_tpu.ops.pallas_stream as jx_ps
from raft_stereo_tpu.corr import pallas_reg as jx_reg
from raft_stereo_tpu.models import update as jx_update
from raft_stereo_tpu.models.layers import init_conv, init_residual_block

import raft_stereo_tpu_torch.models.raft_stereo as port_model
from raft_stereo_tpu_torch import (
    raft_stereo_forward, raft_stereo_inference, raft_stereo_prepare, transplant)
from raft_stereo_tpu_torch.config import lane_pack8_on
from raft_stereo_tpu_torch.corr import reg_cuda
from raft_stereo_tpu_torch.corr.reg_cuda import (
    Lane8, dequantize_feature8, feature_scale8, quantize_feature8)
from raft_stereo_tpu_torch.models.layers import Conv2d, ResidualBlock
from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, FlowHead
from raft_stereo_tpu_torch.ops import encoder as enc
from raft_stereo_tpu_torch.ops import resident, stream
from test_torch_alt import jax_forward, seeded_pair
from test_torch_resident import _arrays, _gru, _load, _resident_case
from test_torch_stream import _gru_case, _gru_modules

CANARY = dict(rtol=5e-3, atol=5e-2)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The parallel test runner puts several worker processes on one CPU;
    a small intra-op pool keeps these tests from starving the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lane8(monkeypatch):
    monkeypatch.setenv("RAFT_LANE_PACK8", "1")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_q(pk, width: int) -> np.ndarray:
    """The JAX container's int8 values, (..., width, C)."""
    g = np.asarray(pk).view(np.int32)
    wq = g.shape[-2]
    by = g.view(np.int8).reshape(*g.shape, 4)  # byte 0 is the lowest
    by = np.moveaxis(by, -1, -3)                # (..., 4, Wq, C)
    return by.reshape(*g.shape[:-2], 4 * wq, g.shape[-1])[..., :width, :]


def _jax_scale(scale) -> np.ndarray:
    return np.asarray(scale, np.float32).reshape(-1)


def _tol(ref) -> float:
    scale = max(1.0, float(np.abs(_np(ref)).max()))
    return (2.0 ** -5 + 2.0 ** -7) * scale


# -- quantization -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("w", [40, 37, 78, 186])
def test_quantize_feature8_equals_jax_container(rng, dtype, w):
    x = rng.standard_normal((2, 12, w, 16)).astype(np.float32)
    x[1] *= 23.0            # another grid for the second sample
    x[:, -3:] = 0.0         # zero rows
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, BF16)
    jx = jnp.asarray(x, jdt)
    jscale = jx_reg.feature_scale8(jx)
    jpk = jx_reg.quantize_pack_feature8(jx, jscale)
    tx = torch.from_numpy(x).to(tdt)
    lane = quantize_feature8(tx)
    assert lane.q.dtype == torch.int8 and lane.q.shape == tx.shape
    assert lane.scale.dtype == torch.float32 and lane.scale.shape == (2,)
    np.testing.assert_array_equal(lane.q.numpy(), _jax_q(jpk, w))
    np.testing.assert_array_equal(lane.scale.numpy(), _jax_scale(jscale))
    np.testing.assert_array_equal(feature_scale8(tx).numpy(), _jax_scale(jscale))
    assert int(lane.q[:, -3:].abs().max()) == 0
    back = dequantize_feature8(lane, torch.float32)
    assert float(back[:, -3:].abs().max()) == 0.0
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jx_reg.unpack_feature8(jpk, jscale, w), np.float32))
    for i in range(2):
        solo = quantize_feature8(tx[i:i + 1])
        assert torch.equal(solo.q, lane.q[i:i + 1]) and torch.equal(solo.scale, lane.scale[i:i + 1])


@pytest.mark.parametrize("value", [None, "1", "on", "TRUE", " yes ", "0", "off", "2"])
def test_lane_switch_parses_like_the_jax_knob(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("RAFT_LANE_PACK8", raising=False)
    else:
        monkeypatch.setenv("RAFT_LANE_PACK8", value)
    assert lane_pack8_on() == jx_reg.lane_pack8() == jx_ps.lane_pack8_on()


@pytest.mark.parametrize("b", [1, 2])
def test_prepare_gru_context_any_equals_jax(rng, monkeypatch, b):
    p, hp, (jh, jxs, jctx), (th, txs, tctx) = _gru_case(rng, b, 16, 24, 32, (32, 32), 64, "bf16")
    gru, _ = _gru_modules(p, hp, 32, 64, 64)
    monkeypatch.delenv("RAFT_LANE_PACK8", raising=False)
    with torch.no_grad():
        plain = stream.prepare_gru_context_any(gru, tctx, BF16)
        assert torch.equal(plain, stream.prepare_gru_context(gru, tctx, BF16))
        monkeypatch.setenv("RAFT_LANE_PACK8", "1")
        lane = stream.prepare_gru_context_any(gru, tctx, BF16)
    jpk, jscale = jx_ps.prepare_gru_context_any(p, jctx, jnp.bfloat16)
    assert isinstance(lane, Lane8) and lane.q.shape == (b, 16, 24, 96)
    # JAX shifts its czrq down one row and pads the flush rows with zeros.
    np.testing.assert_array_equal(lane.q.numpy(), _jax_q(jpk, 24)[:, 1:17])
    np.testing.assert_array_equal(lane.scale.numpy(), _jax_scale(jscale))
    assert torch.equal(lane.q, quantize_feature8(plain).q)


# -- the lane8 modules ----------------------------------------------------------


@pytest.mark.parametrize("head", [False, True])
def test_conv_gru_lane8_matches_pallas(rng, lane8, head):
    ch, nh = 32, 64
    p, hp, (jh, jxs, jctx), (th, txs, tctx) = _gru_case(rng, 1, 16, 24, ch, (32, 32), nh, "bf16")
    packed = jx_ps.prepare_gru_context_any(p, jctx, jnp.bfloat16)
    assert isinstance(packed, tuple)
    ref = jx_ps.fused_conv_gru_fwd_impl(p, jh, packed, *jxs, head_p=hp if head else None)
    gru, fh = _gru_modules(p, hp, ch, 64, nh)
    with torch.no_grad():
        lane = stream.prepare_gru_context_any(gru, tctx, BF16)
        got = stream.fused_conv_gru(stream.gru_weights(gru, BF16), th, lane, *txs,
                                    head=stream.head_weights(fh, BF16) if head else None)
    assert isinstance(lane, Lane8)
    pairs = [(got[0], ref[0])] + ([(got[1], ref[1])] if head else [])
    for g, r in pairs:
        assert float(np.abs(_np(g) - _np(r)).max()) <= _tol(r)


def test_gru1632_lane8_matches_pallas(rng, lane8):
    b, h16, w16, ch = 1, 16, 24, 32
    h32, w32 = h16 // 2, w16 // 2
    p16 = jx_update.init_conv_gru(jax.random.PRNGKey(0), ch, 2 * ch)
    p32 = jx_update.init_conv_gru(jax.random.PRNGKey(1), ch, ch)
    s16, s32 = (b, h16, w16, ch), (b, h32, w32, ch)
    arrays = [rng.standard_normal(s16) * 0.5, rng.standard_normal(s32) * 0.5,
              rng.standard_normal(s16), rng.standard_normal(s32)]
    arrays += [rng.standard_normal(s16) * 0.3 for _ in range(3)]
    arrays += [rng.standard_normal(s32) * 0.3 for _ in range(3)]
    (jh16, jh32, jx0, jx1, *jctx), (th16, th32, tx0, tx1, *tctx) = _arrays(
        "bf16", *[a.astype(np.float32) for a in arrays])
    ref16, ref32 = jx_ps.fused_gru1632_fwd_impl(
        p16, p32, jh16, jh32, jx_ps.prepare_gru_context_any(p16, jctx[:3], jnp.bfloat16),
        jx_ps.prepare_gru_context_any(p32, jctx[3:], jnp.bfloat16), jx0, jx1)
    g16, g32 = _gru(p16, ch, 2 * ch), _gru(p32, ch, ch)
    with torch.no_grad():
        c16 = stream.prepare_gru_context_any(g16, tctx[:3], BF16)
        c32 = stream.prepare_gru_context_any(g32, tctx[3:], BF16)
        got16, got32 = stream.fused_gru1632(
            stream.gru_weights(g16, BF16, "gru16"), stream.gru_weights(g32, BF16, "gru32"),
            th16, th32, c16, c32, tx0, tx1)
    assert isinstance(c16, Lane8) and isinstance(c32, Lane8)
    for g, r in ((got16, ref16), (got32, ref32)):
        assert float(np.abs(_np(g) - _np(r)).max()) <= _tol(r)


def _port_resident_args(penc, pgru, phead, tf1, tf2, coords, tflow, th, tup, tctx, ch, cfg):
    enc_m = _load(BasicMotionEncoder(cfg.cor_planes),
                  {c: penc[c] for c in ("convc1", "convc2", "convf1", "convf2", "conv")})
    gru = _gru(pgru, ch, 128 + ch)
    head = _load(FlowHead(ch, 64, 2), {c: phead[c] for c in ("conv1", "conv2")})
    ops = reg_cuda.build_corr_operands(tf1, tf2, num_levels=4, radius=4)
    with torch.no_grad():
        return (stream.motion_weights(enc_m, BF16), stream.gru_weights(gru, BF16, "gru08"),
                stream.head_weights(head, BF16), ops, th,
                stream.prepare_gru_context_any(gru, tctx, BF16), torch.from_numpy(coords),
                tflow, tup)


def test_fused_iter_lane8_matches_pallas_and_guards_the_switch(rng, monkeypatch, lane8):
    ch, d = 32, 16
    cfg, penc, pgru, phead, fmaps, coords, flow, h, up, ctx = _resident_case(
        rng, 1, 16, 24, ch, d, "bf16")
    (jf1, jf2, jflow, jh, jup, *jctx), (tf1, tf2, tflow, th, tup, *tctx) = _arrays(
        "bf16", *fmaps, flow, h, up, *ctx)
    jops = jx_reg.build_corr_operands(jf1, jf2, num_levels=4, radius=4, out_dtype=jnp.bfloat16)
    ref_h, ref_dx = jx_pr.fused_iter_fwd_impl(
        penc, pgru, phead, jops, jh, jx_ps.prepare_gru_context_any(pgru, jctx, jnp.bfloat16),
        jnp.asarray(coords), jflow, jup)
    args = _port_resident_args(penc, pgru, phead, tf1, tf2, coords, tflow, th, tup, tctx, ch,
                               cfg)
    assert isinstance(args[5], Lane8)
    with torch.no_grad():
        got_h, got_dx = resident.fused_iter(*args)
    for g, r in ((got_h, ref_h), (got_dx, ref_dx)):
        assert float(np.abs(_np(g) - _np(r)).max()) <= _tol(r)
    # A packed czrq outliving the switch fails loudly, on either device.
    monkeypatch.setenv("RAFT_LANE_PACK8", "0")
    with pytest.raises(RuntimeError, match="RAFT_LANE_PACK8"):
        resident.fused_iter(*args)


# -- the q8 exits -------------------------------------------------------------------


def _ints(rng, shape, lo=-2, hi=3):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _filled(module, fill, p):
    """``module`` loaded from JAX parameters ``p`` through the transplant's
    converter ``fill(out, prefix, params)``."""
    out = {}
    fill(out, "m", jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p))
    module.load_state_dict({k[2:]: v for k, v in out.items()}, strict=True)
    return module.eval()


def _conv_pair(pc):
    cin, cout = pc["w"].shape[2:]
    return _filled(Conv2d(cin, cout, 3, padding=1), transplant._conv, pc)


def _block_pair(p, norm_fn):
    ch = p["conv1"]["w"].shape[-1]
    return _filled(ResidualBlock(ch, ch, norm_fn, 1),
                   lambda out, pre, q: transplant._residual_block(out, pre, q, norm_fn), p)


def _q8_cases(rng, integer: bool):
    """(name, JAX q8 call, JAX bf16 call, port q8 call, port bf16 call)."""
    if integer:
        x = _ints(rng, (1, 16, 64, 96), -1, 2)
        pc = {"w": jnp.asarray(_ints(rng, (3, 3, 96, 96), -1, 2)),
              "b": jnp.asarray(_ints(rng, (96,)))}
        xr = _ints(rng, (1, 16, 128, 32), 0, 3)
        pr = init_residual_block(jax.random.PRNGKey(3), 32, 32, "batch", stride=1)
        for cv in ("conv1", "conv2"):
            pr[cv] = {"w": jnp.asarray(_ints(rng, pr[cv]["w"].shape, -1, 2)),
                      "b": jnp.asarray(_ints(rng, pr[cv]["b"].shape))}
        for bn in ("norm1", "norm2"):
            # scale 1 over sqrt(var + eps) == 1 exactly: the fold leaves the
            # integer weights as they are.
            var = np.float32(1.0) - np.float32(1e-5)
            assert var + np.float32(1e-5) == np.float32(1.0)
            c = pr[bn]["scale"].shape
            pr[bn] = {"scale": jnp.ones(c), "bias": jnp.zeros(c), "mean": jnp.zeros(c),
                      "var": jnp.full(c, var)}
        norm_fn = "batch"
    else:
        x = rng.standard_normal((1, 16, 64, 96)).astype(np.float32)
        pc = init_conv(jax.random.PRNGKey(1), 3, 3, 96, 96)
        xr = rng.standard_normal((1, 16, 128, 32)).astype(np.float32)
        pr = init_residual_block(jax.random.PRNGKey(3), 32, 32, "instance", stride=1)
        norm_fn = "instance"
    conv, block = _conv_pair(pc), _block_pair(pr, norm_fn)
    jx, jxr = jnp.asarray(x, jnp.bfloat16), jnp.asarray(xr, jnp.bfloat16)
    tx, txr = torch.from_numpy(x).to(BF16), torch.from_numpy(xr).to(BF16)
    assert jx_pe.head_conv_q8_streamable(pc, jx)
    assert jx_pe.resblock_q8_streamable(pr, jxr, norm_fn)
    assert enc.head_conv_q8_streamable(conv, tx)
    assert enc.resblock_q8_streamable(block, txr, norm_fn)
    return [("head conv", lambda: jx_pe.stream_head_conv_q8(pc, jx),
             lambda: jx_pe.stream_head_conv(pc, jx),
             lambda: enc.stream_head_conv_q8(conv, tx),
             lambda: enc.stream_head_conv(conv, tx)),
            ("resblock", lambda: jx_pe.stream_resblock_q8(norm_fn, pr, jxr),
             lambda: jx_pe.stream_resblock(norm_fn, pr, jxr),
             lambda: enc.stream_resblock_q8(block, txr, norm_fn),
             lambda: enc.stream_resblock(block, txr, norm_fn))]


def test_q8_exits_equal_jax_bytes_on_integer_inputs(rng, lane8):
    for name, jq8, _, pq8, pbf in _q8_cases(rng, integer=True):
        jpk, jscale = jq8()
        with torch.no_grad():
            lane, ref = pq8(), pbf()
        w = lane.q.shape[2]
        np.testing.assert_array_equal(lane.q.numpy(), _jax_q(jpk, w), err_msg=name)
        np.testing.assert_array_equal(lane.scale.numpy(), _jax_scale(jscale), err_msg=name)
        assert float(lane.scale) > 1.0 / 127, name  # the exits are not all zero
        # The exit is the bf16 map's own quantization.
        same = quantize_feature8(ref)
        assert torch.equal(lane.q, same.q) and torch.equal(lane.scale, same.scale), name


def test_q8_exits_near_jax_on_normal_inputs(rng, lane8):
    for name, jq8, jbf, pq8, pbf in _q8_cases(rng, integer=False):
        jpk, jscale = jq8()
        jv = _np(jbf())
        with torch.no_grad():
            lane, v = pq8(), _np(pbf())
        w = lane.q.shape[2]
        dv = np.abs(v - jv)
        s = float(lane.scale)
        dq = np.abs(lane.q.numpy().astype(np.int32) - _jax_q(jpk, w).astype(np.int32))
        assert (dq <= 1 + dv / s).all(), (name, int(dq.max()))
        assert abs(s - float(_jax_scale(jscale)[0])) * 127 <= dv.max(), name
        assert float((dq > 0).mean()) <= 0.05, name


# -- the model --------------------------------------------------------------------

KW = dict(hidden_dims=(32, 32, 32), mixed_precision=True)
# Iterations of the comparisons with JAX's forward. The seeded loop does not
# contract, so one-ulp differences grow with the iterations: at 64x96 the
# bf16 path leaves the canary band after 8 iterations with the switch off as
# well (up to 0.10 px, 0.7-0.9% of the pixels), and stays in it after 3.
# Much of that gap is XLA's: on the CPU it keeps bf16 intermediates in fp32
# where the port rounds them, so JAX's own two bf16 paths differ by up to
# 0.075 px at 8. With the excess precision off (JAX in a subprocess with
# XLA_FLAGS=--xla_allow_excess_precision=false; tests/conftest.py, shared
# with the JAX package's tests, sets its own flags) the port stays in the
# band at 8 (LONG_ITERS).
JAX_ITERS = 3
LONG_ITERS = 8
# The JAX side of the LONG_ITERS case, in its own process: the pickled
# (params, config, images, iterations) in, the (flow_low, flow_up) out.
_JAX_CHILD = """
import dataclasses, pickle, sys
import numpy as np, jax.numpy as jnp, jax
from raft_stereo_tpu.models import raft_stereo_forward
with open(sys.argv[1], "rb") as f:
    params, jcfg, i1, i2, iters = pickle.load(f)
fwd = jax.jit(lambda p, a, b: raft_stereo_forward(p, jcfg, a, b, iters=iters, test_mode=True))
out = [np.asarray(x, np.float32) for x in fwd(params, jnp.asarray(i1), jnp.asarray(i2))]
with open(sys.argv[1] + ".out", "wb") as f:
    pickle.dump(out, f)
"""


def _images(rng):
    return [rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32) for _ in range(2)]


def _lane_keys(state) -> list:
    def has(v):
        if isinstance(v, Lane8):
            return True
        return isinstance(v, (list, tuple)) and any(has(x) for x in v)
    return sorted(k for k, v in state.items() if has(v))


def _jax_lane8_forward(monkeypatch, params, jcfg, impl, i1, i2, iters):
    """JAX's forward with the switch on and its loop kernels in use (the
    encoder kernels off, which keeps its compile short)."""
    monkeypatch.setenv("RAFT_FUSED_ENCODERS", "0")
    try:
        return jax_forward(params, dataclasses.replace(jcfg, fused_update=True), impl, i1, i2,
                           iters)
    finally:
        monkeypatch.delenv("RAFT_FUSED_ENCODERS")


def test_bf16_forward_lane8_matches_jax(rng, monkeypatch, lane8):
    """reg_cuda in bf16: the default loop (gru16+32 and the resident
    iteration on int8 czrq) and the serial loop, against JAX's forward with
    reg_tpu; the port's q8 pass carries the zqr levels. Then the carry:
    int8 containers for inp and the fmaps, bf16 net; two segments of four
    equal one of eight."""
    for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER", "RAFT_FUSED_ENCODERS"):
        monkeypatch.delenv(knob, raising=False)
    model, params, jcfg = seeded_pair(dict(KW, corr_implementation="reg_cuda"), seed=4)
    i1, i2 = _images(rng)
    iters = JAX_ITERS
    ref_lo, ref_up = _jax_lane8_forward(monkeypatch, params, jcfg, "reg_tpu", i1, i2, iters)
    t1, t2 = torch.from_numpy(i1), torch.from_numpy(i2)
    q8_calls = []
    q8 = port_model.stream_head_conv_q8

    def spy(*a, **k):
        q8_calls.append(1)
        return q8(*a, **k)

    monkeypatch.setattr(port_model, "stream_head_conv_q8", spy)
    outs = {}
    for route in ("default", "serial"):
        for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
            monkeypatch.setenv(knob, "1" if route == "default" else "0")
        outs[route] = raft_stereo_forward(model, t1, t2, iters=iters)
    assert len(q8_calls) == 6  # three zqr levels a forward
    for lo, up in outs.values():
        np.testing.assert_allclose(up.numpy(), ref_up, **CANARY)
        np.testing.assert_allclose(lo.numpy(), ref_lo, **CANARY)
    for a, b in zip(outs["default"], outs["serial"]):
        assert torch.equal(a, b)
    for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        monkeypatch.delenv(knob)
    state = raft_stereo_prepare(model, t1, t2)
    assert _lane_keys(state) == ["fmap1", "fmap2", "inp"]
    assert all(n.dtype == BF16 for n in state["net"])
    assert all(lvl.q.dtype == torch.int8 and lvl.q.shape[-1] == 96 for lvl in state["inp"])
    one = raft_stereo_forward(model, t1, t2, iters=8)
    two = raft_stereo_inference(model, t1, t2, iters=8, segments=2)
    for a, b in zip(two, one):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused_update", [True, False], ids=["loop_kernels", "torch_loop"])
def test_bf16_forward_matches_jax_at_8_iterations(rng, monkeypatch, tmp_path, fused_update):
    """reg_cuda in bf16 with the switch off, the default loop (gru16+32 and
    the resident iteration) and the serial loop, LONG_ITERS iterations,
    against JAX's forward with reg_tpu and its loop kernels (the encoder
    kernels off, as in the JAX_ITERS case) in a process of its own with
    XLA's excess precision off: the canary band. With ``fused_update``
    off (the breaker ladder's bottom rung) both packages run the loop
    plain, and the port stays in the same band."""
    import os
    import pickle
    import subprocess
    import sys
    for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER", "RAFT_LANE_PACK8"):
        monkeypatch.delenv(knob, raising=False)
    model, params, jcfg = seeded_pair(dict(KW, corr_implementation="reg_cuda"), seed=4)
    model.cfg.fused_update = fused_update
    assert model.cfg.loop_kernels(test_mode=True) is fused_update
    i1, i2 = _images(rng)
    jcfg = dataclasses.replace(jcfg, corr_implementation="reg_tpu", fused_update=fused_update)
    path = tmp_path / "jax_case.pkl"
    with open(path, "wb") as f:
        pickle.dump((jax.tree_util.tree_map(np.asarray, params), jcfg, i1, i2, LONG_ITERS), f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER", "RAFT_LANE_PACK8")}
    env.update(XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu",
               RAFT_FUSED_ENCODERS="0", OMP_NUM_THREADS="2")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.run([sys.executable, "-c", _JAX_CHILD, str(path)], env=env, cwd=repo,
                           capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stderr[-4000:]
    with open(str(path) + ".out", "rb") as f:
        ref_lo, ref_up = pickle.load(f)
    t1, t2 = torch.from_numpy(i1), torch.from_numpy(i2)
    outs = {}
    for route in ("default", "serial"):
        for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
            monkeypatch.setenv(knob, "1" if route == "default" else "0")
        outs[route] = raft_stereo_forward(model, t1, t2, iters=LONG_ITERS)
    for lo, up in outs.values():
        np.testing.assert_allclose(up.numpy(), ref_up, **CANARY)
        np.testing.assert_allclose(lo.numpy(), ref_lo, **CANARY)
    for a, b in zip(outs["default"], outs["serial"]):
        assert torch.equal(a, b)


def test_fp32_forward_lane8_matches_jax(rng, monkeypatch, lane8):
    """reg in fp32: no kernel, so the zqr levels and the fmaps quantize on
    the host and czrq stays fp32."""
    kw = dict(KW, mixed_precision=False, corr_implementation="reg")
    model, params, jcfg = seeded_pair(kw, seed=5)
    i1, i2 = _images(rng)
    ref_lo, ref_up = jax_forward(params, jcfg, "reg", i1, i2, iters=8)
    state = raft_stereo_prepare(model, torch.from_numpy(i1), torch.from_numpy(i2))
    assert _lane_keys(state) == ["fmap1", "fmap2", "inp"]
    assert state["inp"][0].q.dtype == torch.int8 and state["net"][0].dtype == torch.float32
    lo, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2), iters=8)
    np.testing.assert_allclose(up.numpy(), ref_up, **CANARY)
    np.testing.assert_allclose(lo.numpy(), ref_lo, **CANARY)


def test_lane_switch_off_is_unset(rng, monkeypatch):
    """Unset and "0" are the same run, bit for bit, with a carry free of
    containers; on, the result differs."""
    model, _, _ = seeded_pair(dict(KW, corr_implementation="reg_cuda"), seed=6)
    t1, t2 = (torch.from_numpy(a) for a in _images(rng))
    monkeypatch.delenv("RAFT_LANE_PACK8", raising=False)
    unset = raft_stereo_forward(model, t1, t2, iters=2)
    assert _lane_keys(raft_stereo_prepare(model, t1, t2)) == []
    monkeypatch.setenv("RAFT_LANE_PACK8", "0")
    off = raft_stereo_forward(model, t1, t2, iters=2)
    assert _lane_keys(raft_stereo_prepare(model, t1, t2)) == []
    for a, b in zip(unset, off):
        assert torch.equal(a, b)
    monkeypatch.setenv("RAFT_LANE_PACK8", "1")
    on = raft_stereo_forward(model, t1, t2, iters=2)
    assert not torch.equal(on[1], off[1])
