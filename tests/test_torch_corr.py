"""The port's correlation (raft_stereo_tpu_torch.corr) against the JAX
package's: ``reg`` (fp32, XLA lookup) and ``reg_tpu`` (whose lookup runs the
Pallas ``_lookup_kernel``, in interpret mode on the CPU).

On the CPU the port's ``reg_cuda`` lookup runs its plain version, which does
the CUDA kernel's arithmetic: the same taps and fp32 lerp, each multiply and
add rounded. XLA's CPU code may contract the lerp into a fused
multiply-add, so a lerped value may land an fp32 ulp apart. With integer
feature maps every volume entry and pyramid tap is exact, so the packages
agree to an fp32 ulp of the largest tap, and in bf16 to one bf16 ulp of each
value. With normal feature maps the bf16 volume may also round one ulp
apart (the matmuls sum in different orders), which moves a lerped tap by at
most a few ulps of the largest tap.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_stereo_tpu.corr import make_corr_fn as jx_make_corr_fn

from raft_stereo_tpu_torch.corr import make_corr_fn
from raft_stereo_tpu_torch.corr import reg_cuda

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


def _case(rng, b, h, w, d, integer: bool):
    if integer:
        f1 = rng.integers(-2, 3, (b, h, w, d)).astype(np.float32)
        f2 = rng.integers(-2, 3, (b, h, w, d)).astype(np.float32)
    else:
        f1 = rng.standard_normal((b, h, w, d)).astype(np.float32)
        f2 = rng.standard_normal((b, h, w, d)).astype(np.float32)
    # Positions past both ends of the row, fractional everywhere.
    coords = rng.uniform(-9.0, w + 9.0, (b, h, w)).astype(np.float32)
    return f1, f2, coords


def _jax(impl, f1, f2, coords, kind, levels, radius):
    fn = jx_make_corr_fn(impl, jnp.asarray(f1, JDT[kind]), jnp.asarray(f2, JDT[kind]),
                         num_levels=levels, radius=radius, out_dtype=JDT[kind])
    return np.asarray(fn(jnp.asarray(coords)), np.float32)


def _port(impl, f1, f2, coords, kind, levels, radius):
    t = TDT[kind]
    fn = make_corr_fn(impl, torch.from_numpy(f1).to(t), torch.from_numpy(f2).to(t),
                      num_levels=levels, radius=radius, out_dtype=t)
    out = fn(torch.from_numpy(coords))
    assert out.dtype == t
    return out.float().numpy()


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("w", [20, 37])
@pytest.mark.parametrize("levels,radius", [(4, 4), (2, 3)])
def test_reg_cuda_matches_reg_tpu_on_integer_fmaps(rng, kind, w, levels, radius):
    f1, f2, coords = _case(rng, 2, 3, w, 16, integer=True)
    ref = _jax("reg_tpu", f1, f2, coords, kind, levels, radius)
    got = _port("reg_cuda", f1, f2, coords, kind, levels, radius)
    assert got.shape == (2, 3, w, levels * (2 * radius + 1))
    err = np.abs(got - ref)
    if kind == "fp32":
        assert float(err.max()) <= 2.0 ** -23 * float(np.abs(ref).max())
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert float((err / ulp).max()) <= 1.0


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("w", [20, 37])
def test_reg_cuda_matches_reg_tpu_normal_fmaps(rng, kind, w):
    f1, f2, coords = _case(rng, 1, 4, w, 32, integer=False)
    ref = _jax("reg_tpu", f1, f2, coords, kind, 4, 4)
    got = _port("reg_cuda", f1, f2, coords, kind, 4, 4)
    scale = float(np.abs(ref).max())
    # fp32: summation order; bf16: 4 ulps of the largest tap (2^-8 each).
    tol = 1e-5 * scale if kind == "fp32" else 4 * 2.0 ** -8 * scale
    assert float(np.abs(got - ref).max()) <= tol


@pytest.mark.parametrize("impl", ["reg", "reg_cuda"])
@pytest.mark.parametrize("w", [20, 37])
def test_port_fp32_matches_jax_reg(rng, impl, w):
    """Both port lookups against the JAX package's fp32 ``reg``."""
    f1, f2, coords = _case(rng, 2, 3, w, 16, integer=False)
    ref = _jax("reg", f1, f2, coords, "fp32", 4, 4)
    got = _port(impl, f1, f2, coords, "fp32", 4, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))


def test_lookup_wrapper_takes_plain_version_on_cpu(rng):
    f1, f2, coords = _case(rng, 1, 2, 24, 16, integer=False)
    ops = reg_cuda.build_corr_operands(torch.from_numpy(f1), torch.from_numpy(f2),
                                       num_levels=3, radius=2)
    assert ops.widths == (24, 12, 6)
    assert [tuple(lvl.shape) for lvl in ops.levels] == [(48, 24), (48, 12), (48, 6)]
    c = torch.from_numpy(coords)
    assert torch.equal(reg_cuda.lookup(ops, c), reg_cuda.lookup_plain(ops, c))


def test_build_corr_operands_rejects_other_out_dtype(rng):
    f1, f2, _ = _case(rng, 1, 2, 8, 16, integer=True)
    with pytest.raises(ValueError):
        reg_cuda.build_corr_operands(torch.from_numpy(f1), torch.from_numpy(f2),
                                     num_levels=2, radius=2, out_dtype=torch.bfloat16)
