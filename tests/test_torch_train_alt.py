"""Training through the ``alt`` correlations against the JAX package, on the
CPU (helpers and tolerances of test_torch_train.py).

- fp32 ``alt``: the port's gradients against JAX's eager ``value_and_grad``
  (raw: the BatchNorm statistics are not stop-gradiented here), every leaf
  within ``1e-4 * max|g_jax| + 1e-6 + 3 * max|g_port32 - g_port64|``.
- The BatchNorm statistics' route difference (ROADMAP Queue C): JAX's raw
  gradients give the ``mean``/``var`` leaves nonzero values; in the port
  they are buffers, outside the parameters the optimizer takes (and so
  outside the weight decay and the clip norm). Passing them through
  ``lax.stop_gradient`` changes no other leaf's gradient, so this file's
  raw comparison and test_torch_train.py's stop-gradient one pin both
  halves.
- bf16 ``alt_cuda`` (the alt kernel's ``torch.autograd.Function`` on the
  port's side, its backward autograd through the plain alt lookup) against
  the JAX package's ``alt_tpu`` route (its Pallas kernel in interpret mode
  and its ``custom_vjp``), B=2, 128x256, in the bands of
  test_torch_train.py (``check_bf16_case``), the plain loop in bf16 on both
  sides.
"""

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
from raft_stereo_tpu_torch.corr import alt_cuda
from tests.test_torch_train import (
    SMALL, assert_fp32_grads_match, assert_nonzero_leaves, batch, check_bf16_case, jax_grads,
    jax_params, port_grads, port_grads64, port_model)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_alt_fp32_gradients_and_bn_statistics():
    cfg_kw = dict(SMALL, corr_implementation="alt")
    model = port_model(cfg_kw)
    data = batch(0, 1, 64, 128)
    jloss, raw, _ = jax_grads(jax_params(model, cfg_kw), cfg_kw, data, stop_bn=False,
                              jit=False)
    ploss, pgrads = port_grads(model, data)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    assert_nonzero_leaves(pgrads, "port")
    assert_nonzero_leaves({n: raw[n] for n in pgrads}, "jax")
    assert_fp32_grads_match(pgrads, raw, port_grads64(model, data)[1])
    # The route difference: JAX's statistics leaves move, the port's are
    # buffers the optimizer never sees.
    stats = [k for k in raw if k.endswith(("running_mean", "running_var"))]
    assert stats and max(float(np.abs(raw[k]).max()) for k in stats) > 0
    state = model.state_dict(keep_vars=True)
    assert all(k in state and k not in pgrads and not state[k].requires_grad for k in stats)
    opt = make_optimizer(model, 2e-4, 100)
    assert {id(p) for p in opt.params} == {id(p) for p in model.parameters()}
    assert not any(id(state[k]) in {id(p) for p in opt.params} for k in stats)


def test_alt_cuda_bf16_gradients_in_band(monkeypatch):
    calls = []
    launch = alt_cuda.lookup_launch
    monkeypatch.setattr(alt_cuda, "lookup_launch", lambda *a: calls.append(1) or launch(*a))
    cfg_kw = dict(SMALL, corr_implementation="alt_cuda", mixed_precision=True)
    check_bf16_case(cfg_kw, dict(cfg_kw, corr_implementation="alt_tpu"), 2)
    # 3 iterations, and the recompute of each under checkpointing.
    assert len(calls) == 6
