"""The refinement loop's kernels (raft_stereo_tpu_torch.ops.stream) and the
plain update modules (raft_stereo_tpu_torch.models.update) against the JAX
package's Pallas kernels (``fused_conv_gru_fwd_impl``,
``fused_motion_fwd_impl``, interpret mode on the CPU) and its XLA modules.

On the CPU each kernel wrapper runs its plain version, which rounds where the
CUDA kernel and the Pallas kernel do. Tolerances:
- fp32 (the Pallas kernels forced onto fp32 through the package's test hook):
  summation order only, 2e-5 of the output's scale;
- bf16: convolutions summed in another order can put a bf16 rounding of z,
  r, q, f1 (or c1..f2) one ulp apart, which carries into the outputs: h'
  and the motion features within 8 bf16 ulps at their scale (2^-5), the
  head's x delta within 2^-5 of its scale.

tests/test_torch_gpu.py holds the same kernels against their plain versions
on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raft_stereo_tpu.ops.pallas_stream as ps
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import update as jx_update

from raft_stereo_tpu_torch import transplant
from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
from raft_stereo_tpu_torch.ops import stream

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


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


def _load(module, fill):
    out = {}
    fill(out)
    module.load_state_dict({k[2:]: v for k, v in out.items()}, strict=True)
    return module


def _gru_modules(p, hp, ch, cin, nh):
    gru = _load(ConvGRU(ch, cin), lambda o: [
        transplant._conv(o, f"m.{g}", p[g]) for g in ("convz", "convr", "convq")])
    head = _load(FlowHead(ch, nh, 2), lambda o: [
        transplant._conv(o, f"m.{c}", hp[c]) for c in ("conv1", "conv2")])
    return gru, head


def _gru_case(rng, b, h, w, ch, parts, nh, kind):
    p = jx_update.init_conv_gru(jax.random.PRNGKey(0), ch, sum(parts))
    hp = jx_update.init_flow_head(jax.random.PRNGKey(1), ch, nh, 2)
    hst = (rng.standard_normal((b, h, w, ch)) * 0.5).astype(np.float32)
    xs = [rng.standard_normal((b, h, w, c)).astype(np.float32) for c in parts]
    ctx = [(rng.standard_normal((b, h, w, ch)) * 0.3).astype(np.float32) for _ in range(3)]
    j = lambda a: jnp.asarray(a, JDT[kind])  # noqa: E731
    t = lambda a: torch.from_numpy(a).to(TDT[kind])  # noqa: E731
    return p, hp, (j(hst), [j(x) for x in xs], [j(c) for c in ctx]), \
        (t(hst), [t(x) for x in xs], [t(c) for c in ctx])


def _tol(kind, ref) -> float:
    scale = max(1.0, float(np.abs(_np(ref)).max()))
    return (2e-5 if kind == "fp32" else 2.0 ** -5) * scale


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,w,ch,parts", [(1, 16, 24, 32, (32, 32)),
                                            (1, 8, 13, 32, (64,)),
                                            (2, 16, 20, 32, (32, 64, 32))])
def test_conv_gru_matches_pallas(rng, monkeypatch, kind, b, h, w, ch, parts):
    monkeypatch.setattr(ps, "FORCE_FUSABLE_DTYPE", True)
    nh = 64
    p, hp, (jh, jxs, jctx), (th, txs, tctx) = _gru_case(rng, b, h, w, ch, parts, nh, kind)
    jczrq = ps.prepare_gru_context(p, jctx, JDT[kind])
    ref_h, _ = ps.fused_conv_gru_fwd_impl(p, jh, jczrq, *jxs)
    ref_h2, ref_dx = ps.fused_conv_gru_fwd_impl(p, jh, jczrq, *jxs, head_p=hp)
    gru, head = _gru_modules(p, hp, ch, sum(parts), nh)
    with torch.no_grad():
        wts = stream.gru_weights(gru, TDT[kind])
        hw = stream.head_weights(head, TDT[kind])
        czrq = stream.prepare_gru_context(gru, tctx, TDT[kind])
        got_h, none = stream.fused_conv_gru(wts, th, czrq, *txs)
        got_h2, got_dx = stream.fused_conv_gru(wts, th, czrq, *txs, head=hw)
    assert none is None and got_h.dtype == TDT[kind] and got_dx.dtype == torch.float32
    assert got_dx.shape == (b, h, w, 1)
    # The head does not change h'.
    assert torch.equal(got_h, got_h2)
    for got, ref in ((got_h, ref_h), (got_dx, ref_dx)):
        assert float(np.abs(_np(got) - _np(ref)).max()) <= _tol(kind, ref)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("b", [1, 2])
def test_motion_matches_pallas(rng, monkeypatch, kind, b):
    monkeypatch.setattr(ps, "FORCE_FUSABLE_DTYPE", True)
    cfg = JaxConfig()
    pm = jx_update.init_motion_encoder(jax.random.PRNGKey(2), cfg)
    h, w = 16, 21
    corr = rng.standard_normal((b, h, w, cfg.cor_planes)).astype(np.float32)
    flow = np.concatenate([rng.standard_normal((b, h, w, 1)) * 3,
                           np.zeros((b, h, w, 1))], -1).astype(np.float32)
    ref = ps.fused_motion_fwd_impl(pm, jnp.asarray(flow, JDT[kind]),
                                   jnp.asarray(corr, JDT[kind]))
    enc = _load(BasicMotionEncoder(cfg.cor_planes), lambda o: [
        transplant._conv(o, f"m.{c}", pm[c])
        for c in ("convc1", "convc2", "convf1", "convf2", "conv")])
    with torch.no_grad():
        wts = stream.motion_weights(enc, TDT[kind])
        got = stream.fused_motion(wts, torch.from_numpy(flow).to(TDT[kind]),
                                  torch.from_numpy(corr).to(TDT[kind]))
    assert got.shape == (b, h, w, 128) and got.dtype == TDT[kind]
    assert float(np.abs(_np(got) - _np(ref)).max()) <= _tol(kind, ref[..., :126])
    # The raw flow rides along as channels 126:128.
    np.testing.assert_array_equal(_np(got)[..., 126:], _np(ref)[..., 126:])


def test_motion_integer_exact(rng, monkeypatch):
    """Integer weights and inputs keep every fp32 sum exact, so the plain
    version must equal the Pallas motion kernel bit for bit: any tap, halo,
    block-diagonal or channel-order slip shows as an integer-sized error."""
    monkeypatch.setattr(ps, "FORCE_FUSABLE_DTYPE", True)
    cfg = JaxConfig()
    pm = jx_update.init_motion_encoder(jax.random.PRNGKey(0), cfg)
    pm = jax.tree_util.tree_map(
        lambda t: jnp.asarray(rng.integers(-2, 3, t.shape), jnp.float32), pm)
    corr = rng.integers(-3, 4, (1, 16, 24, cfg.cor_planes)).astype(np.float32)
    flow = np.concatenate([rng.integers(-3, 4, (1, 16, 24, 1)),
                           np.zeros((1, 16, 24, 1))], -1).astype(np.float32)
    ref = ps.fused_motion_fwd_impl(pm, jnp.asarray(flow), jnp.asarray(corr))
    enc = _load(BasicMotionEncoder(cfg.cor_planes), lambda o: [
        transplant._conv(o, f"m.{c}", pm[c])
        for c in ("convc1", "convc2", "convf1", "convf2", "conv")])
    with torch.no_grad():
        got = stream.fused_motion(stream.motion_weights(enc, torch.float32),
                                  torch.from_numpy(flow), torch.from_numpy(corr))
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_update_modules_match_jax(rng, kind):
    """The plain modules (ConvGRU, BasicMotionEncoder, FlowHead) against
    apply_conv_gru / apply_motion_encoder / apply_flow_head. fp32 to 2e-5
    of scale; bf16 to 2^-5 of scale (chains of rounded ops)."""
    cfg = JaxConfig()
    ch, parts = 32, (32, 32)
    p, hp, (jh, jxs, jctx), (th, txs, tctx) = _gru_case(rng, 2, 9, 11, ch, parts, 64, kind)
    gru, head = _gru_modules(p, hp, ch, sum(parts), 64)
    pm = jx_update.init_motion_encoder(jax.random.PRNGKey(3), cfg)
    enc = _load(BasicMotionEncoder(cfg.cor_planes), lambda o: [
        transplant._conv(o, f"m.{c}", pm[c])
        for c in ("convc1", "convc2", "convf1", "convf2", "conv")])
    corr = rng.standard_normal((2, 9, 11, cfg.cor_planes)).astype(np.float32)
    flow = (rng.standard_normal((2, 9, 11, 2)) * 2).astype(np.float32)  # y != 0 here
    with torch.no_grad():
        pairs = [
            (gru(th, tctx, *txs), jx_update.apply_conv_gru(p, jh, jctx, *jxs)),
            (head(th), jx_update.apply_flow_head(hp, jh)),
            (enc(torch.from_numpy(flow).to(TDT[kind]), torch.from_numpy(corr).to(TDT[kind])),
             jx_update.apply_motion_encoder(pm, jnp.asarray(flow, JDT[kind]),
                                            jnp.asarray(corr, JDT[kind]))),
        ]
    for got, ref in pairs:
        assert got.dtype == TDT[kind]
        assert float(np.abs(_np(got) - _np(ref)).max()) <= _tol(kind, ref)
