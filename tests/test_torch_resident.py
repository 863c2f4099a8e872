"""The JAX package's default refinement loop in the port: the gru16+32
co-schedule (``ops/stream.py:fused_gru1632``) and the resident iteration
(``ops/resident.py:fused_iter``), against the JAX package's Pallas kernels
(``fused_gru1632_fwd_impl``, ``fused_iter_fwd_impl``, interpret mode on the
CPU), and the model's routing between them and the serial kernels.

On the CPU each wrapper runs its plain version, which rounds where the CUDA
kernel and the Pallas kernel do. Tolerances as in test_torch_stream.py:
fp32 (the Pallas kernels forced onto fp32 through the package's test hook)
2e-5 of the output's scale, summation order only; bf16 2^-5 of the scale
for h' and dx, since convolutions summed in another order can put a bf16
rounding of z, r, q or f1 one ulp apart. End to end, the serving canary
band (rtol 5e-3, atol 5e-2 px) with the flow head tempered as in
test_torch_model.py.

tests/test_torch_gpu.py holds the CUDA kernels against their plain versions
and, bit for bit, against the serial CUDA chain on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raft_stereo_tpu.corr.pallas_reg as jx_pallas_reg
import raft_stereo_tpu.ops.pallas_resident as jx_pr
import raft_stereo_tpu.ops.pallas_stream as jx_ps
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import init_raft_stereo as jx_init
from raft_stereo_tpu.models import raft_stereo_forward as jx_forward
from raft_stereo_tpu.models import update as jx_update

import raft_stereo_tpu_torch.models.update as port_update
from raft_stereo_tpu_torch import (
    RAFTStereo, RAFTStereoConfig, init_raft_stereo, raft_stereo_forward, transplant)
from raft_stereo_tpu_torch.corr import reg_cuda
from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
from raft_stereo_tpu_torch.ops import resident, stream
from raft_stereo_tpu_torch.transplant import load_state_dict, params_from_jax

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
SMALL = dict(hidden_dims=(32, 32, 32))
CANARY = dict(rtol=5e-3, atol=5e-2)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The parallel test runner puts several worker processes on one CPU;
    a small intra-op pool keeps these tests from starving the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jx_forward_jit(cfg, iters: int):
    """The JAX package's test-mode forward, jitted: traced once (kernel
    calls counted at the trace, as eagerly) and on the CPU about twice as
    fast as its eager interpreter."""
    return jax.jit(lambda p, a, b, flow_init=None: jx_forward(
        p, cfg, a, b, iters=iters, test_mode=True, flow_init=flow_init))




def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(kind, ref) -> float:
    scale = max(1.0, float(np.abs(_np(ref)).max()))
    return (2e-5 if kind == "fp32" else 2.0 ** -5) * scale


def _load(module, prefix_params):
    out = {}
    for name, p in prefix_params.items():
        transplant._conv(out, f"m.{name}", p)
    module.load_state_dict({k[2:]: v for k, v in out.items()}, strict=True)
    return module


def _gru(p, ch, cin):
    return _load(ConvGRU(ch, cin), {g: p[g] for g in ("convz", "convr", "convq")})


def _arrays(kind, *arrays):
    return ([jnp.asarray(a, JDT[kind]) for a in arrays],
            [torch.from_numpy(a).to(TDT[kind]) for a in arrays])


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h16,w16,ch", [(1, 16, 24, 32), (1, 32, 18, 64), (2, 16, 16, 32)])
def test_gru1632_matches_pallas(rng, monkeypatch, kind, b, h16, w16, ch):
    monkeypatch.setattr(jx_ps, "FORCE_FUSABLE_DTYPE", True)
    h32, w32 = h16 // 2, w16 // 2
    cx0 = ch
    p16 = jx_update.init_conv_gru(jax.random.PRNGKey(0), ch, cx0 + ch)
    p32 = jx_update.init_conv_gru(jax.random.PRNGKey(1), ch, ch)
    s16 = (b, h16, w16, ch)
    s32 = (b, h32, w32, ch)
    arrays = [rng.standard_normal(s16) * 0.5, rng.standard_normal(s32) * 0.5,
              rng.standard_normal((b, h16, w16, cx0)), rng.standard_normal(s32)]
    arrays += [rng.standard_normal(s16) * 0.3 for _ in range(3)]
    arrays += [rng.standard_normal(s32) * 0.3 for _ in range(3)]
    (jh16, jh32, jx0, jx1, *jctx), (th16, th32, tx0, tx1, *tctx) = _arrays(
        kind, *[a.astype(np.float32) for a in arrays])
    ref16, ref32 = jx_ps.fused_gru1632_fwd_impl(
        p16, p32, jh16, jh32, jx_ps.prepare_gru_context(p16, jctx[:3], JDT[kind]),
        jx_ps.prepare_gru_context(p32, jctx[3:], JDT[kind]), jx0, jx1)
    g16, g32 = _gru(p16, ch, cx0 + ch), _gru(p32, ch, ch)
    with torch.no_grad():
        w16_, w32_ = stream.gru_weights(g16, TDT[kind], "gru16"), stream.gru_weights(
            g32, TDT[kind], "gru32")
        got16, got32 = stream.fused_gru1632(
            w16_, w32_, th16, th32, stream.prepare_gru_context(g16, tctx[:3], TDT[kind]),
            stream.prepare_gru_context(g32, tctx[3:], TDT[kind]), tx0, tx1)
    assert got16.shape == s16 and got32.shape == s32 and got16.dtype == TDT[kind]
    for got, ref in ((got16, ref16), (got32, ref32)):
        assert float(np.abs(_np(got) - _np(ref)).max()) <= _tol(kind, ref)


def _resident_case(rng, b, hh, ww, ch, d, kind):
    cfg = JaxConfig()
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    penc = jx_update.init_motion_encoder(keys[0], cfg)
    pgru = jx_update.init_conv_gru(keys[1], ch, 128 + ch)
    phead = jx_update.init_flow_head(keys[2], ch, 64, 2)
    f32 = np.float32
    fmaps = [rng.standard_normal((b, hh, ww, d)).astype(f32) for _ in range(2)]
    coords = (rng.uniform(0, 1, (b, hh, ww)) * ww).astype(f32)
    flow = np.concatenate([rng.standard_normal((b, hh, ww, 1)),
                           np.zeros((b, hh, ww, 1))], -1).astype(f32)
    h = (rng.standard_normal((b, hh, ww, ch)) * 0.5).astype(f32)
    up = rng.standard_normal((b, hh, ww, ch)).astype(f32)
    ctx = [(rng.standard_normal((b, hh, ww, ch)) * 0.3).astype(f32) for _ in range(3)]
    return cfg, penc, pgru, phead, fmaps, coords, flow, h, up, ctx


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("b,hh,ww", [(1, 16, 24), (2, 8, 20)])
def test_fused_iter_matches_pallas(rng, monkeypatch, kind, b, hh, ww):
    monkeypatch.setattr(jx_ps, "FORCE_FUSABLE_DTYPE", True)
    ch, d = 32, 16
    cfg, penc, pgru, phead, fmaps, coords, flow, h, up, ctx = _resident_case(
        rng, b, hh, ww, ch, d, kind)
    (jf1, jf2, jflow, jh, jup, *jctx), (tf1, tf2, tflow, th, tup, *tctx) = _arrays(
        kind, *fmaps, flow, h, up, *ctx)
    jops = jx_pallas_reg.build_corr_operands(jf1, jf2, num_levels=4, radius=4,
                                             out_dtype=JDT[kind])
    ref_h, ref_dx = jx_pr.fused_iter_fwd_impl(
        penc, pgru, phead, jops, jh, jx_ps.prepare_gru_context(pgru, jctx, JDT[kind]),
        jnp.asarray(coords), jflow, jup)
    enc = _load(BasicMotionEncoder(cfg.cor_planes),
                {c: penc[c] for c in ("convc1", "convc2", "convf1", "convf2", "conv")})
    gru = _gru(pgru, ch, 128 + ch)
    head = _load(FlowHead(ch, 64, 2), {c: phead[c] for c in ("conv1", "conv2")})
    ops = reg_cuda.build_corr_operands(tf1, tf2, num_levels=4, radius=4)
    with torch.no_grad():
        got_h, got_dx = resident.fused_iter(
            stream.motion_weights(enc, TDT[kind]), stream.gru_weights(gru, TDT[kind], "gru08"),
            stream.head_weights(head, TDT[kind]), ops, th,
            stream.prepare_gru_context(gru, tctx, TDT[kind]), torch.from_numpy(coords),
            tflow, tup)
    assert got_h.shape == (b, hh, ww, ch) and got_h.dtype == TDT[kind]
    assert got_dx.shape == (b, hh, ww, 1) and got_dx.dtype == torch.float32
    for got, ref in ((got_h, ref_h), (got_dx, ref_dx)):
        assert float(np.abs(_np(got) - _np(ref)).max()) <= _tol(kind, ref)


def _temper(params):
    conv2 = params["update_block"]["flow_head"]["conv2"]
    conv2["w"], conv2["b"] = conv2["w"] * 0.02, conv2["b"] * 0.02
    return params


def _port_from_jax(params, cfg_kw) -> RAFTStereo:
    cfg = RAFTStereoConfig(**cfg_kw)
    model = RAFTStereo(cfg)
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    load_state_dict(model, params_from_jax(np_params, cfg))
    return model.eval()


def _images(rng, h, w, b=1):
    return [rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32) for _ in range(2)]


def _count(monkeypatch, calls, module, name, key):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls[key] += 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


def test_bf16_forward_matches_jax_default_loop(rng, monkeypatch):
    """JAX runs its default loop (encoder kernels off): the scan body traces
    _gru1632_kernel and _resident_kernel once each and none of the serial
    kernels; the port runs its default loop (plain versions on the CPU)."""
    monkeypatch.setenv("RAFT_FUSED_ENCODERS", "0")
    for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        monkeypatch.delenv(knob, raising=False)
    calls = dict.fromkeys(("gru1632", "iter", "lookup", "motion", "gru"), 0)
    _count(monkeypatch, calls, jx_ps, "fused_gru1632_fwd_impl", "gru1632")
    _count(monkeypatch, calls, jx_pr, "fused_iter_fwd_impl", "iter")
    _count(monkeypatch, calls, jx_pallas_reg, "_pallas_lookup", "lookup")
    _count(monkeypatch, calls, jx_ps, "fused_motion_fwd_impl", "motion")
    _count(monkeypatch, calls, jx_ps, "fused_conv_gru_fwd_impl", "gru")
    kw = dict(SMALL, corr_implementation="reg_tpu", mixed_precision=True)
    params = _temper(jx_init(jax.random.PRNGKey(2), JaxConfig(**kw)))
    i1, i2 = _images(rng, 128, 256)
    ref_lo, ref_up = _jx_forward_jit(JaxConfig(**kw), 3)(params, jnp.asarray(i1),
                                                         jnp.asarray(i2))
    assert calls == {"gru1632": 1, "iter": 1, "lookup": 0, "motion": 0, "gru": 0}, calls
    model = _port_from_jax(params, dict(kw, corr_implementation="reg_cuda"))
    lo, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref_up, np.float32), **CANARY)
    np.testing.assert_allclose(lo.numpy(), np.asarray(ref_lo, np.float32), **CANARY)


def _port_counts(monkeypatch):
    calls = dict.fromkeys(("fused_iter", "fused_gru1632", "lookup", "fused_motion",
                           "fused_conv_gru"), 0)
    _count(monkeypatch, calls, port_update, "fused_iter", "fused_iter")
    for name in ("fused_gru1632", "fused_motion", "fused_conv_gru"):
        _count(monkeypatch, calls, stream, name, name)
    _count(monkeypatch, calls, reg_cuda, "lookup", "lookup")
    return calls


@pytest.mark.parametrize("warm", [False, True])
def test_port_routes_default_and_serial_loops(rng, monkeypatch, warm):
    """The port's own wrapper calls per frame. Default: one fused_iter and
    one fused_gru1632 an iteration and no serial kernel. Both switches off:
    slice 1's serial chain. A flow_init keeps the resident iteration off
    (its motion encoder drops the flow-y weights) and, as in the JAX
    package, the co-schedule on. Each route gives the other's bits."""
    iters = 2
    model = init_raft_stereo(RAFTStereoConfig(**SMALL, corr_implementation="reg_cuda",
                                              mixed_precision=True), seed=7, device="cpu")
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.02)
    i1, i2 = (torch.from_numpy(a) for a in _images(rng, 64, 128))
    init = torch.from_numpy(rng.standard_normal((1, 16, 32, 2)).astype(np.float32)) \
        if warm else None
    outs, counts = {}, {}
    for route in ("default", "serial"):
        for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
            monkeypatch.setenv(knob, "1" if route == "default" else "off")
        with monkeypatch.context() as m:
            calls = _port_counts(m)
            outs[route] = raft_stereo_forward(model, i1, i2, iters=iters, flow_init=init)
            counts[route] = dict(calls)
    serial = {"fused_iter": 0, "fused_gru1632": 0, "lookup": iters,
              "fused_motion": 0 if warm else iters, "fused_conv_gru": 3 * iters}
    if warm:
        default = dict(serial, fused_gru1632=iters, fused_conv_gru=iters)
    else:
        default = {"fused_iter": iters, "fused_gru1632": iters, "lookup": 0,
                   "fused_motion": 0, "fused_conv_gru": 0}
    assert counts == {"default": default, "serial": serial}, counts
    for a, b in zip(outs["default"], outs["serial"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("value", [None, "1", "on", "0", "false", "No", " off ", "2"])
def test_switches_parse_like_the_jax_knobs(monkeypatch, value):
    from raft_stereo_tpu_torch.config import fuse_gru1632_on, fuse_iter_on
    for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
    assert fuse_iter_on() == jx_pr.fuse_iter_on()
    assert fuse_gru1632_on() == fuse_iter_on()


@pytest.mark.parametrize("b,h,w", [(1, 64, 96), (2, 128, 256), (1, 32, 1696)])
def test_port_matches_jax_where_jax_skips_its_kernels(rng, monkeypatch, b, h, w):
    """At B=1 64x96 gru32 has 4 rows, under the 8 the JAX kernels need
    (``gru_is_fusable``), so JAX runs gru32 (and so gru16+32) in XLA; at
    B=2 128x256 the frame is under ``stream_batch_crossover`` and JAX runs
    every GRU and motion step in XLA; both with the encoder kernels off.
    With them on, at width 1696 no strip width suits the JAX package's compiler (``_strip_wb``,
    and ``_strip_cols`` at 848 and 424), so its context net runs in XLA.
    The port's kernels take every shape, and must stay in the canary band
    of JAX's route there too."""
    encoders = w == 1696
    monkeypatch.setenv("RAFT_FUSED_ENCODERS", "1" if encoders else "0")
    if encoders:
        from raft_stereo_tpu.ops import pallas_encoder as jx_pe
        assert jx_pe._strip_wb(w) == 0 and jx_pe._strip_cols(w // 2) == 0
        assert jx_pe._strip_cols(w // 4) == 0
    kw = dict(SMALL, corr_implementation="reg_tpu", mixed_precision=True)
    params = _temper(jx_init(jax.random.PRNGKey(5), JaxConfig(**kw)))
    i1, i2 = _images(rng, h, w, b)
    ref_lo, ref_up = _jx_forward_jit(JaxConfig(**kw), 3)(params, jnp.asarray(i1),
                                                         jnp.asarray(i2))
    model = _port_from_jax(params, dict(kw, corr_implementation="reg_cuda"))
    lo, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref_up, np.float32), **CANARY)
    np.testing.assert_allclose(lo.numpy(), np.asarray(ref_lo, np.float32), **CANARY)


def test_lerp_taps_rebuild_the_resize_matrix():
    """The upsample taps the gru16+32 kernel reads are the resize matrix's
    own entries: scattered back they give the matrix bit for bit, including
    the last row, where both taps are one index."""
    from raft_stereo_tpu_torch.ops.resize import _lerp_matrix, lerp_taps
    cpu = torch.device("cpu")
    for n_in, n_out in ((24, 48), (78, 156), (4, 8), (3, 6), (7, 13)):
        idx, wt = lerp_taps(n_in, n_out, torch.bfloat16, cpu)
        m = _lerp_matrix(n_in, n_out, torch.bfloat16, cpu)
        rebuilt = torch.zeros_like(m).scatter_add_(1, idx.long(), wt)
        assert torch.equal(rebuilt, m)
        assert idx[-1].tolist() == [n_in - 1, n_in - 1] and wt[-1, 1] == 0



def _gru1632_args(b, h16, w16, ch, seed):
    """gru16+32 arguments on the CPU, bf16, x0p of ``ch`` channels."""
    from raft_stereo_tpu_torch.models.layers import init_weights
    g16, g32 = ConvGRU(ch, 2 * ch), ConvGRU(ch, ch)
    for i, m in enumerate((g16, g32)):
        init_weights(m, torch.Generator().manual_seed(seed + i))
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16

    def rnd(shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(bf)

    h32, w32 = h16 // 2, w16 // 2
    with torch.no_grad():
        w16_, w32_ = stream.gru_weights(g16, bf, "gru16"), stream.gru_weights(g32, bf, "gru32")
        czrq16 = stream.prepare_gru_context(g16, [rnd((b, h16, w16, ch), 0.3)] * 3, bf)
        czrq32 = stream.prepare_gru_context(g32, [rnd((b, h32, w32, ch), 0.3)] * 3, bf)
    return (w16_, w32_, rnd((b, h16, w16, ch), 0.5), rnd((b, h32, w32, ch), 0.5), czrq16,
            czrq32, rnd((b, h16, w16, ch), 1.0), rnd((b, h32, w32, ch), 1.0))


@pytest.mark.parametrize("b,h16,w16,size08", [(1, 16, 24, (32, 48)), (2, 8, 20, (16, 39)),
                                              (1, 6, 10, (11, 20))])
def test_gru1632_builds_gru08_input_as_the_resize(b, h16, w16, size08):
    """With gru08's size, gru16+32's plain version (what the wrapper runs on
    the CPU) gives the two states it gives without it and, third,
    interp_align_corners of h16' bit for bit (odd sizes too: the last
    tap). Under grad the resize stays outside the launch, and the gradient
    through the third output is the plain version's."""
    from raft_stereo_tpu_torch.ops.resize import interp_align_corners
    args = _gru1632_args(b, h16, w16, 32, 70)
    with torch.no_grad():
        two = stream.gru1632_plain(*args)
        three = stream.gru1632_plain(*args, size08=size08)
        fused = stream.fused_gru1632(*args, size08=size08)
    assert len(two) == 2 and len(three) == 3 and len(fused) == 3
    for a, b_ in zip(two, three):
        assert torch.equal(a, b_)
    assert torch.equal(three[2], interp_align_corners(three[0], size08))
    for a, b_ in zip(three, fused):
        assert torch.equal(a, b_)
    h16 = args[2].float().requires_grad_(True)
    grads = []
    for fn in (stream.fused_gru1632, stream.gru1632_plain):
        out = fn(*args[:2], h16.to(torch.bfloat16), *args[3:], size08=size08)
        assert torch.equal(out[2], three[2])
        grads.append(torch.autograd.grad(out[2].float().square().sum(), h16)[0])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("route", ["resident", "warm", "slow_fast"])
def test_gru08_input_comes_from_gru1632_where_it_runs(rng, monkeypatch, route):
    """Where gru16+32 runs, gru08's upsampled input is its third output: the
    model step calls interp_align_corners itself nowhere (default loop),
    in the plain step (a flow_init: the resident iteration off) and under
    slow-fast (32 of the 64 gru16+32 calls give it, the pre-step's none).
    With RAFT_FUSE_GRU1632=0 the step resizes every level itself. Both
    routes give the same bits."""
    iters = 2
    cfg = RAFTStereoConfig(**SMALL, corr_implementation="reg_cuda", mixed_precision=True,
                           slow_fast_gru=route == "slow_fast")
    model = init_raft_stereo(cfg, seed=9, device="cpu")
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.02)
    i1, i2 = (torch.from_numpy(a) for a in _images(rng, 64, 128))
    init = torch.from_numpy(rng.standard_normal((1, 16, 32, 2)).astype(np.float32)) \
        if route == "warm" else None
    monkeypatch.delenv("RAFT_FUSE_ITER", raising=False)
    outs, counts = {}, {}
    for fuse in ("1", "0"):
        monkeypatch.setenv("RAFT_FUSE_GRU1632", fuse)
        calls = {"interp": 0, "gru1632": 0, "gru1632:size08": 0}
        with monkeypatch.context() as m:
            interp, fused = port_update.interp_align_corners, stream.fused_gru1632

            def counted_interp(*a, **k):
                calls["interp"] += 1
                return interp(*a, **k)

            def counted_fused(*a, **k):
                calls["gru1632:size08" if k.get("size08") else "gru1632"] += 1
                return fused(*a, **k)

            m.setattr(port_update, "interp_align_corners", counted_interp)
            m.setattr(stream, "fused_gru1632", counted_fused)
            outs[fuse] = raft_stereo_forward(model, i1, i2, iters=iters, flow_init=init)
        counts[fuse] = calls
    pre = iters if route == "slow_fast" else 0
    assert counts == {"1": {"interp": 0, "gru1632": pre, "gru1632:size08": iters},
                      "0": {"interp": 2 * iters + pre, "gru1632": 0, "gru1632:size08": 0}}
    for a, b in zip(outs["1"], outs["0"]):
        assert torch.equal(a, b)
