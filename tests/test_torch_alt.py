"""The port's alt correlation against the JAX package's: ``alt`` (fp32,
plain torch) against JAX ``alt`` (one-hot XLA sampling), and ``alt_cuda``
(on the CPU, its plain version) against JAX ``alt_tpu``, whose
``_alt_kernel`` runs in interpret mode here.

Tolerances: fp32 1e-5 of the largest tap, summation order only (the port
and JAX dot in other orders). bf16: one bf16 ulp of each value. Both sides
pool the bf16 fmap2 rows alike and keep the volume in fp32 until the one
downcast, so the fp32 taps differ by association only and the downcast can
land one ulp apart. The model with ``alt_cuda`` stays in the serving canary
band (rtol 5e-3, atol 5e-2 px) of the JAX package's forward with
``alt_tpu``, the flow head tempered as in test_torch_model.py.

tests/test_torch_gpu.py holds the CUDA kernel against its plain version on
the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.corr import make_corr_fn as jx_make_corr_fn
from raft_stereo_tpu.models import raft_stereo_forward as jx_forward
from raft_stereo_tpu.transplant.torch_loader import transplant_state_dict

import raft_stereo_tpu_torch.models.update as port_update
from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo, raft_stereo_forward
from raft_stereo_tpu_torch.corr import alt_cuda, make_corr_fn, reg_cuda
from raft_stereo_tpu_torch.ops import stream

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
SMALL = dict(hidden_dims=(32, 32, 32))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The parallel test runner puts several worker processes on one CPU;
    a small intra-op pool keeps these tests from starving the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(rng, b, h, w, d):
    f1 = rng.standard_normal((b, h, w, d)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, d)).astype(np.float32)
    # Fractional positions past both ends of the row, and a few far off it.
    coords = rng.uniform(-9.0, w + 9.0, (b, h, w)).astype(np.float32)
    far = coords.reshape(-1)[::7]
    far[:] = rng.choice([-1e6, -w - 500.0, w + 500.0, 1e6], far.size)
    return f1, f2, coords


def _jax(impl, f1, f2, coords, kind, levels=4, radius=4):
    fn = jx_make_corr_fn(impl, jnp.asarray(f1, JDT[kind]), jnp.asarray(f2, JDT[kind]),
                         num_levels=levels, radius=radius, out_dtype=JDT[kind])
    return np.asarray(fn(jnp.asarray(coords)), np.float32)


def _port(impl, f1, f2, coords, kind, levels=4, radius=4):
    t = TDT[kind]
    fn = make_corr_fn(impl, torch.from_numpy(f1).to(t), torch.from_numpy(f2).to(t),
                      num_levels=levels, radius=radius, out_dtype=t)
    out = fn(torch.from_numpy(coords))
    assert out.dtype == t
    return out.float().numpy()


def _ulps(got, ref):
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    return float((np.abs(got - ref) / ulp).max())


@pytest.mark.parametrize("b,w,levels,radius", [(2, 37, 4, 4), (1, 200, 3, 2)])
def test_alt_matches_jax_alt_fp32(rng, b, w, levels, radius):
    f1, f2, coords = _case(rng, b, 3, w, 16)
    ref = _jax("alt", f1, f2, coords, "fp32", levels, radius)
    got = _port("alt", f1, f2, coords, "fp32", levels, radius)
    assert got.shape == ref.shape == (b, 3, w, levels * (2 * radius + 1))
    assert float(np.abs(got - ref).max()) <= 1e-5 * float(np.abs(ref).max())


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("b,w,d", [(2, 37, 16), (1, 200, 32), (1, 376, 16)])
def test_alt_cuda_plain_matches_jax_alt_tpu(rng, kind, b, w, d):
    """Odd width, widths over 128 (the JAX package pads to 256 and 384
    before pooling), B = 2, coords far off the row."""
    f1, f2, coords = _case(rng, b, 2, w, d)
    ref = _jax("alt_tpu", f1, f2, coords, kind)
    got = _port("alt_tpu", f1, f2, coords, kind)
    assert got.shape == ref.shape == (b, 2, w, 36)
    far = np.abs(coords - w / 2) > w + 100
    assert (got[far] == 0).all() and (ref[far] == 0).all()
    if kind == "fp32":
        assert float(np.abs(got - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    else:
        assert _ulps(got, ref) <= 1.0


def _frame_field(rng, b, h, w):
    """A frame-like x field, as the refinement loop's coordinates are: each
    pixel's column less a smooth disparity of 0 to W/8, up to 2 px of noise;
    the first columns pushed past the row's left end and the last ones past
    its right end."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    disp = (w / 8) * 0.5 * (1 + np.sin(2 * np.pi * (1.3 * xx + 0.7 * yy)))
    coords = np.arange(w)[None] - disp + rng.uniform(-2, 2, (h, w))
    coords[:, :4] -= 10.0
    coords[:, -4:] += 10.0
    return np.broadcast_to(coords, (b, h, w)).astype(np.float32).copy()


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_alt_cuda_plain_matches_jax_alt_tpu_on_a_frame_field(rng, kind):
    """The kernel's windows on the card follow the coordinates; here its
    plain version on a smooth frame-like field, with positions past both
    ends of the row, against JAX ``alt_tpu`` (the Pallas kernel in
    interpret mode), at the tolerances above."""
    b, h, w, d = 1, 3, 150, 16
    f1 = rng.standard_normal((b, h, w, d)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, d)).astype(np.float32)
    coords = _frame_field(rng, b, h, w)
    ref = _jax("alt_tpu", f1, f2, coords, kind)
    got = _port("alt_tpu", f1, f2, coords, kind)
    assert got.shape == ref.shape == (b, h, w, 36)
    if kind == "fp32":
        assert float(np.abs(got - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    else:
        assert _ulps(got, ref) <= 1.0


def test_alt_plain_and_alt_cuda_agree_with_reg(rng):
    """Sampling then dotting is the reg lookup up to association, in fp32."""
    f1, f2, coords = _case(rng, 1, 3, 45, 16)
    ref = _port("reg", f1, f2, coords, "fp32")
    for impl in ("alt", "alt_cuda"):
        got = _port(impl, f1, f2, coords, "fp32")
        assert float(np.abs(got - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def test_alt_operands_and_the_wrapper_on_cpu(rng):
    f1, f2, coords = _case(rng, 2, 3, 21, 8)
    t1, t2 = torch.from_numpy(f1).bfloat16(), torch.from_numpy(f2).bfloat16()
    ops = alt_cuda.build_alt_operands(t1, t2, num_levels=3, radius=2)
    assert ops.widths == (21, 10, 5)
    assert tuple(ops.f1.shape) == (2 * 3 * 21, 8)
    assert [tuple(lvl.shape) for lvl in ops.levels] == [(6, 21, 8), (6, 10, 8), (6, 5, 8)]
    # Each level pools the one before it, rounded to bf16 at every level.
    lv1 = t2.reshape(6, 21, 8)[:, :20].unflatten(1, (10, 2))
    assert torch.equal(ops.levels[1], (lv1[:, :, 0] + lv1[:, :, 1]) * 0.5)
    c = torch.from_numpy(coords)
    assert torch.equal(alt_cuda.lookup(ops, c), alt_cuda.lookup_plain(ops, c))
    assert torch.equal(alt_cuda.lookup_plain(ops, c, rows=1), alt_cuda.lookup_plain(ops, c))
    with pytest.raises(ValueError):
        alt_cuda.build_alt_operands(t1, t2, num_levels=2, radius=2, out_dtype=torch.float32)


def seeded_pair(kw: dict, seed: int):
    """The port's model with seeded weights, the flow head's last conv
    scaled by 1/50 (see test_torch_model.py), and the JAX package's
    parameters transplanted from it (cheaper than the JAX init)."""
    model = init_raft_stereo(RAFTStereoConfig(**kw), seed=seed, device="cpu")
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.02)
        model.update_block.flow_head.conv2.bias.mul_(0.02)
    jcfg = JaxConfig(**{k: v for k, v in kw.items() if k != "corr_implementation"},
                     fused_update=False)
    return model, transplant_state_dict(model.state_dict(), jcfg), jcfg


def jax_forward(params, jcfg, impl: str, i1, i2, iters: int):
    """The JAX package's test-mode forward, jitted (its eager dispatch is
    the slow part on the CPU)."""
    cfg = dataclasses.replace(jcfg, corr_implementation=impl)
    fwd = jax.jit(lambda p, a, b: jx_forward(p, cfg, a, b, iters=iters, test_mode=True))
    return [np.asarray(x, np.float32) for x in fwd(params, jnp.asarray(i1), jnp.asarray(i2))]


def test_bf16_forward_with_alt_cuda_matches_jax_alt_tpu(rng, monkeypatch):
    """The model end to end; JAX's refinement runs _alt_kernel (interpret
    mode) with its GRU and motion steps in XLA (``fused_update`` off, which
    keeps this test short; test_torch_resident.py holds the loop kernels),
    the port's the alt kernel's plain version. The port's loop calls the alt
    lookup, the gru16+32, motion and gru08+head wrappers once an iteration
    and never the lookup or the resident iteration: there are no reg
    operands to gather from."""
    monkeypatch.setenv("RAFT_FUSED_ENCODERS", "0")
    for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        monkeypatch.delenv(knob, raising=False)
    kw = dict(SMALL, corr_implementation="alt_cuda", mixed_precision=True)
    model, params, jcfg = seeded_pair(kw, seed=3)
    i1, i2 = (rng.uniform(0, 255, (1, 64, 128, 3)).astype(np.float32) for _ in range(2))
    iters = 2
    ref_lo, ref_up = jax_forward(params, jcfg, "alt_tpu", i1, i2, iters)
    calls = dict.fromkeys(("alt", "lookup", "fused_iter", "gru1632", "motion", "gru"), 0)
    for module, name, key in ((alt_cuda, "lookup", "alt"), (reg_cuda, "lookup", "lookup"),
                              (port_update, "fused_iter", "fused_iter"),
                              (stream, "fused_gru1632", "gru1632"),
                              (stream, "fused_motion", "motion"),
                              (stream, "fused_conv_gru", "gru")):
        def counted(*a, _fn=getattr(module, name), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, name, counted)
    lo, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2),
                                 iters=iters)
    assert calls == {"alt": iters, "lookup": 0, "fused_iter": 0, "gru1632": iters,
                     "motion": iters, "gru": iters}, calls
    np.testing.assert_allclose(up.numpy(), ref_up, rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(lo.numpy(), ref_lo, rtol=5e-3, atol=5e-2)


def test_demo_cli_with_alt_cuda_on_cpu(tmp_path, rng):
    """``python -m raft_stereo_tpu_torch.demo --corr_implementation alt_cuda
    --device cpu``: the plain versions end to end."""
    from PIL import Image

    from raft_stereo_tpu_torch import demo
    model = init_raft_stereo(RAFTStereoConfig(**SMALL), seed=4, device="cpu")
    torch.save(model.state_dict(), tmp_path / "w.pth")
    for name in ("im0.png", "im1.png"):
        (tmp_path / "a").mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (40, 70, 3), dtype=np.uint8)).save(
            tmp_path / "a" / name)
    out = tmp_path / "out"
    demo.main(["--restore_ckpt", str(tmp_path / "w.pth"), "-l", str(tmp_path / "*/im0.png"),
               "-r", str(tmp_path / "*/im1.png"), "--output_directory", str(out),
               "--valid_iters", "2", "--hidden_dims", "32", "32", "32", "--save_numpy",
               "--corr_implementation", "alt_cuda", "--device", "cpu"])
    disp = np.load(out / "a.npy")
    assert disp.shape == (40, 70) and np.isfinite(disp).all()
