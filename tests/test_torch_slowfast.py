"""``slow_fast_gru`` in the port against the JAX package, on the CPU.

- fp32 ``reg`` against JAX ``reg`` at 64x128, 3 iterations, 1e-4 px, at 2
  and 3 GRU levels, with and without the shared backbone, ``n_downsample``
  2 and 3; the last case is the reference's realtime model (shared
  backbone, ``n_downsample`` 3, 2 levels).
- bf16 ``reg_cuda`` (the kernels' plain versions) against JAX ``reg_tpu``
  with its loop kernels (interpret mode), within the serving canary band
  (rtol 5e-3, atol 5e-2 px), the flow head tempered as in
  test_torch_model.py; the default loop and the serial one
  (``RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0``) give the same bits, and an
  iteration calls the loop wrappers as the card launches them: 3 levels,
  one gru32 step, two gru16+32 and one resident iteration; 2 levels, two
  gru16 steps and one resident iteration.
- Every one of the 24 flag combinations of the JAX package's matrix
  (``tests/test_model.py``) wires up on the meta device.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch import RAFTStereo, RAFTStereoConfig, raft_stereo_forward
from raft_stereo_tpu_torch.models import update as port_update
from raft_stereo_tpu_torch.ops import stream
from test_torch_alt import jax_forward, seeded_pair

CANARY = dict(rtol=5e-3, atol=5e-2)
SMALL = dict(hidden_dims=(32, 32, 32), slow_fast_gru=True)
REALTIME = dict(shared_backbone=True, n_downsample=3, n_gru_layers=2)
ARCHS = {"3lvl": dict(n_gru_layers=3), "2lvl": dict(n_gru_layers=2),
         "3lvl_shared_ds3": dict(n_gru_layers=3, shared_backbone=True, n_downsample=3),
         "2lvl_ds3": dict(n_gru_layers=2, n_downsample=3),
         "realtime": REALTIME}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The parallel test runner puts several worker processes on one CPU;
    a small intra-op pool keeps these tests from starving the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(rng, h, w):
    return [rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("arch", list(ARCHS.values()), ids=list(ARCHS))
def test_fp32_slow_fast_matches_jax_reg(rng, arch):
    model, params, jcfg = seeded_pair(dict(SMALL, **arch), seed=11)
    i1, i2 = _images(rng, 64, 128)
    ref_lo, ref_up = jax_forward(params, jcfg, "reg", i1, i2, iters=3)
    lo, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    np.testing.assert_allclose(up.numpy(), ref_up, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lo.numpy(), ref_lo, rtol=0, atol=1e-4)


def _count_calls(monkeypatch) -> dict:
    calls = dict.fromkeys(("gru1632", "gru", "fused_iter"), 0)
    for module, name, key in ((stream, "fused_gru1632", "gru1632"),
                              (stream, "fused_conv_gru", "gru"),
                              (port_update, "fused_iter", "fused_iter")):
        def counted(*a, _fn=getattr(module, name), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch,per_iter", [
    (dict(n_gru_layers=3), {"gru1632": 2, "gru": 1, "fused_iter": 1}),
    (REALTIME, {"gru1632": 0, "gru": 2, "fused_iter": 1})], ids=["3lvl", "realtime"])
def test_bf16_slow_fast_matches_jax_reg_tpu(rng, monkeypatch, arch, per_iter):
    """JAX runs its loop kernels (gru16+32, the head-less GRU steps and the
    resident iteration, interpret mode); its encoder kernels are off, which
    keeps the compile short."""
    for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        monkeypatch.delenv(knob, raising=False)
    kw = dict(SMALL, mixed_precision=True, corr_implementation="reg_cuda", **arch)
    model, params, jcfg = seeded_pair(kw, seed=12)
    i1, i2 = _images(rng, 128, 256)
    iters = 3
    monkeypatch.setenv("RAFT_FUSED_ENCODERS", "0")
    ref_lo, ref_up = jax_forward(params, dataclasses.replace(jcfg, fused_update=True), "reg_tpu",
                                 i1, i2, iters)
    monkeypatch.delenv("RAFT_FUSED_ENCODERS")
    t1, t2 = torch.from_numpy(i1), torch.from_numpy(i2)
    calls = _count_calls(monkeypatch)
    default = raft_stereo_forward(model, t1, t2, iters=iters)
    assert calls == {k: n * iters for k, n in per_iter.items()}, calls
    for knob in ("RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        monkeypatch.setenv(knob, "0")
    serial = raft_stereo_forward(model, t1, t2, iters=iters)
    for a, b in zip(default, serial):
        assert torch.equal(a, b)
    lo, up = default
    np.testing.assert_allclose(up.numpy(), ref_up, **CANARY)
    np.testing.assert_allclose(lo.numpy(), ref_lo, **CANARY)


FLAGS = list(itertools.product([1, 2, 3], [2, 3], [False, True], [False, True]))


@pytest.mark.parametrize("n_gru_layers,n_downsample,shared_backbone,slow_fast_gru", FLAGS)
def test_all_flag_combinations_wire_up(n_gru_layers, n_downsample, shared_backbone,
                                       slow_fast_gru):
    """The test-mode forward of every combination on the meta device (no
    values: shapes only)."""
    cfg = RAFTStereoConfig(n_gru_layers=n_gru_layers, n_downsample=n_downsample,
                           shared_backbone=shared_backbone, slow_fast_gru=slow_fast_gru)
    with torch.device("meta"):
        model = RAFTStereo(cfg).eval()
        image = torch.zeros((2, 32, 64, 3))
    lo, up = raft_stereo_forward(model, image, image, iters=2)
    f = cfg.downsample_factor
    assert lo.shape == (2, 32 // f, 64 // f, 2) and up.shape == (2, 32, 64, 1)
