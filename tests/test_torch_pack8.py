"""``RAFT_CORR_PACK8`` in the port: ``reg_cuda``'s int8 levels, the int8
mode of the lookup and of the resident iteration, against the JAX package's
``reg_tpu`` with the same switch (``level_scale8``, ``quantize_pack_rows8``
and the lookup's ``packed8`` mode, interpret mode on the CPU).

On the CPU the wrappers run their plain versions: dequantize each tap as
``q * scale`` in fp32, lerp in fp32, one downcast, as the kernels do.

Tolerances:
- integer feature maps make every bf16 volume entry and pooled level exact
  in both packages, so the int8 levels and their scales must equal the JAX
  package's container bit for bit, and the taps agree to one bf16 ulp (the
  JAX package's CPU code may contract the lerp into a fused multiply-add);
- with normal feature maps the bf16 volumes may round one ulp apart (the
  matmuls sum in other orders), which can move a quantized tap by one step:
  within one scale of each level and sample, plus a bf16 ulp of the value;
- the JAX package's pins, on the port: per level and sample the int8 taps
  stay within ``scale / 2`` of the bf16 taps (in fp32, before the
  downcast; 1e-4 relative slack for the fp32 arithmetic), taps off the row
  are exact zeros, batched rows equal B=1 rows bit for bit, and the switch
  defaults off and does nothing for fp32 volumes;
- the model with ``reg_cuda`` + pack8, whose default loop runs the resident
  iteration on the int8 levels, within the serving canary band (rtol 5e-3,
  atol 5e-2 px) of the JAX package's forward. (The resident iteration's
  plain version is the lookup's, the motion encoder's and the ConvGRU's,
  each held against the JAX package alone.)

tests/test_torch_gpu.py holds the CUDA kernels' int8 mode against their
plain versions, and the resident kernel bit for bit against the serial
chain, on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raft_stereo_tpu.corr.pallas_reg as jx_reg

import raft_stereo_tpu_torch.models.update as port_update
from raft_stereo_tpu_torch import raft_stereo_forward
from raft_stereo_tpu_torch.config import corr_pack8_on
from raft_stereo_tpu_torch.corr import reg_cuda
from test_torch_alt import _ulps, jax_forward, seeded_pair

BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The parallel test runner puts several worker processes on one CPU;
    a small intra-op pool keeps these tests from starving the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pack8(monkeypatch):
    monkeypatch.setenv("RAFT_CORR_PACK8", "1")


def _case(rng, b, h, w, d, integer: bool):
    if integer:
        fmaps = [rng.integers(-2, 3, (b, h, w, d)).astype(np.float32) for _ in range(2)]
    else:
        fmaps = [rng.standard_normal((b, h, w, d)).astype(np.float32) for _ in range(2)]
    coords = rng.uniform(-9.0, w + 9.0, (b, h, w)).astype(np.float32)
    return fmaps, coords


def _jax_ops(fmaps, levels, radius):
    f1, f2 = (jnp.asarray(f, jnp.bfloat16) for f in fmaps)
    return jx_reg.build_corr_operands(f1, f2, num_levels=levels, radius=radius,
                                      out_dtype=jnp.bfloat16)


def _port_ops(fmaps, levels, radius, dtype=torch.bfloat16):
    f1, f2 = (torch.from_numpy(f).to(dtype) for f in fmaps)
    return reg_cuda.build_corr_operands(f1, f2, num_levels=levels, radius=radius)


def _jax_int8_levels(ops):
    """The JAX package's combined container, cut back into per-level
    (B*N, W_l) int8 rows (byte 0 of a lane is the lowest position)."""
    container = np.asarray(ops["kernel_ops"][0]).view(np.int8)
    b, n = container.shape[:2]
    out = []
    for lvl, (_, mode, base) in enumerate(ops["spec"]):
        assert mode == "packed8"
        w = ops["widths"][lvl]
        out.append(container[..., 4 * base:4 * base + w].reshape(b * n, w))
    return out


def _jax_taps(ops, coords):
    return np.asarray(jx_reg.corr_fn_from_operands(ops)(jnp.asarray(coords)), np.float32)


@pytest.mark.parametrize("b,w,levels,radius", [(2, 37, 4, 4), (1, 40, 2, 3)])
def test_pack8_levels_equal_jax_on_integer_fmaps(rng, pack8, b, w, levels, radius):
    fmaps, coords = _case(rng, b, 3, w, 16, integer=True)
    jops = _jax_ops(fmaps, levels, radius)
    ops = _port_ops(fmaps, levels, radius)
    assert jops["pack8"] and ops.pack8
    assert ops.scales.shape == (b, levels) and ops.scales.dtype == torch.float32
    for lvl, (q, jq) in enumerate(zip(ops.levels8, _jax_int8_levels(jops))):
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), jq), lvl
        assert np.array_equal(ops.scales[:, lvl].numpy(),
                              np.asarray(jops["scales"][lvl]).reshape(b)), lvl
    got = reg_cuda.lookup(ops, torch.from_numpy(coords))
    assert got.dtype == torch.bfloat16
    assert _ulps(got.float().numpy(), _jax_taps(jops, coords)) <= 1.0


def test_pack8_taps_within_a_step_of_jax_on_normal_fmaps(rng, pack8):
    fmaps, coords = _case(rng, 2, 4, 45, 32, integer=False)
    jops = _jax_ops(fmaps, 4, 4)
    ops = _port_ops(fmaps, 4, 4)
    ref = _jax_taps(jops, coords)
    got = reg_cuda.lookup(ops, torch.from_numpy(coords)).float().numpy()
    for lvl in range(4):
        sl = slice(9 * lvl, 9 * lvl + 9)
        step = ops.scales[:, lvl].numpy()[:, None, None, None]
        assert (np.abs(got[..., sl] - ref[..., sl])
                <= step + BF16_ULP * np.abs(ref[..., sl])).all(), lvl


@pytest.mark.parametrize("b,w,levels,radius", [(1, 40, 4, 4), (2, 37, 2, 3)])
def test_pack8_error_budget(rng, monkeypatch, b, w, levels, radius):
    """The JAX package's pins (tests/test_corr.py): the budget at the
    default pyramid, and at an odd width with a 2-level pyramid."""
    fmaps, coords = _case(rng, b, 6, w, 16, integer=False)
    c = torch.from_numpy(coords)
    ref = reg_cuda.lookup_plain(_port_ops(fmaps, levels, radius), c, out_dtype=torch.float32)
    monkeypatch.setenv("RAFT_CORR_PACK8", "1")
    ops = _port_ops(fmaps, levels, radius)
    got = reg_cuda.lookup_plain(ops, c, out_dtype=torch.float32)
    k = 2 * radius + 1
    for lvl in range(levels):
        err = (got[..., lvl * k:(lvl + 1) * k] - ref[..., lvl * k:(lvl + 1) * k]).abs()
        assert (err.amax(dim=(1, 2, 3)) <= 0.5 * ops.scales[:, lvl] * (1 + 1e-4)).all(), lvl
    far = torch.full_like(c, -1000.0)
    assert float(reg_cuda.lookup(ops, far).float().abs().max()) == 0.0


def test_pack8_default_off_and_inert_for_fp32(rng, monkeypatch):
    fmaps, _ = _case(rng, 1, 2, 20, 16, integer=False)
    monkeypatch.delenv("RAFT_CORR_PACK8", raising=False)
    assert not _port_ops(fmaps, 4, 4).pack8
    monkeypatch.setenv("RAFT_CORR_PACK8", "1")
    ops32 = _port_ops(fmaps, 4, 4, torch.float32)
    assert not ops32.pack8 and ops32.scales is None
    assert reg_cuda.kernel_levels(ops32, torch.device("cpu"))[2] == 0
    assert reg_cuda.kernel_levels(_port_ops(fmaps, 4, 4), torch.device("cpu"))[2] == 2


def test_pack8_batched_rows_equal_single_rows(rng, pack8):
    """Per-sample scales: a sample's int8 levels and taps do not depend on
    its batchmates (sample 1 at 17x the contrast)."""
    fmaps, coords = _case(rng, 2, 3, 40, 16, integer=False)
    for f in fmaps:
        f[1] *= 17.0
    batched = _port_ops(fmaps, 4, 4)
    taps = reg_cuda.lookup(batched, torch.from_numpy(coords))
    n = 3 * 40
    for i in range(2):
        solo = _port_ops([f[i:i + 1] for f in fmaps], 4, 4)
        assert torch.equal(batched.scales[i:i + 1], solo.scales)
        for q, qs in zip(batched.levels8, solo.levels8):
            assert torch.equal(q[i * n:(i + 1) * n], qs)
        assert torch.equal(taps[i:i + 1], reg_cuda.lookup(solo, torch.from_numpy(
            coords[i:i + 1])))


@pytest.mark.parametrize("value", [None, "1", "on", "TRUE", " yes ", "0", "off", "2"])
def test_pack8_switch_parses_like_the_jax_knob(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("RAFT_CORR_PACK8", raising=False)
    else:
        monkeypatch.setenv("RAFT_CORR_PACK8", value)
    assert corr_pack8_on() == jx_reg.corr_pack8()


def test_bf16_forward_with_pack8_matches_jax(rng, monkeypatch, pack8):
    """The model with ``reg_cuda`` and RAFT_CORR_PACK8=1: the port's default
    loop (the resident iteration, on the int8 levels) against the JAX
    package's forward with ``reg_tpu`` and the same switch, its lookup kernel
    on its int8 container (GRU and motion steps in XLA, as in
    test_torch_alt.py)."""
    monkeypatch.setenv("RAFT_FUSED_ENCODERS", "0")
    for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        monkeypatch.delenv(knob, raising=False)
    kw = dict(hidden_dims=(32, 32, 32), corr_implementation="reg_cuda", mixed_precision=True)
    model, params, jcfg = seeded_pair(kw, seed=6)
    i1, i2 = (rng.uniform(0, 255, (1, 64, 128, 3)).astype(np.float32) for _ in range(2))
    ref_lo, ref_up = jax_forward(params, jcfg, "reg_tpu", i1, i2, iters=2)
    seen = []
    fused_iter = port_update.fused_iter

    def spy(*a, **k):
        seen.append(a[3].pack8)
        return fused_iter(*a, **k)

    monkeypatch.setattr(port_update, "fused_iter", spy)
    lo, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2), iters=2)
    assert seen == [True, True]
    np.testing.assert_allclose(up.numpy(), ref_up, rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(lo.numpy(), ref_lo, rtol=5e-3, atol=5e-2)
