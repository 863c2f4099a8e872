"""Training through the kernels of the ``reg_cuda`` route at B=1 in bf16
under ``fused_train``, against the JAX package's kernel route there
(``reg_tpu``: its Pallas kernels in interpret mode and their ``custom_vjp``
backward), 128x256, 3 iterations, in the bands of test_torch_train.py
(``check_bf16_case``). At B=1 every differentiable kernel entry engages:
the lookup, the context net's encoder chains (stem + layer1, layer2[1],
layer3[1], and each of the two finest heads' residual block and conv: 7),
and under ``fused_train`` the GRU with the head at gru08, gru16+32 and the
motion encoder. The loop entries run once an iteration and once more in
the checkpointed recompute; the encoder chains once (outside it); the
resident iteration never.
"""

import pytest
import torch

from raft_stereo_tpu_torch.corr import reg_cuda
from raft_stereo_tpu_torch.ops import encoder as enc
from raft_stereo_tpu_torch.ops import resident, stream
from tests.test_torch_train import SMALL, check_bf16_case


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(name) or fn(*a, **k))


def test_reg_cuda_b1_fused_train_bf16_gradients_in_band(monkeypatch):
    calls = []
    _spy(monkeypatch, reg_cuda, "lookup_launch", calls)
    for name in ("conv_gru_launch", "motion_launch", "gru1632_launch"):
        _spy(monkeypatch, stream, name, calls)
    _spy(monkeypatch, resident, "fused_iter", calls)
    _spy(monkeypatch, enc, "_chain", calls)
    cfg_kw = dict(SMALL, corr_implementation="reg_cuda", mixed_precision=True, fused_train=True)
    check_bf16_case(cfg_kw, dict(cfg_kw, corr_implementation="reg_tpu"), 1)
    n = 2 * 3
    assert {k: calls.count(k) for k in set(calls)} == {
        "lookup_launch": n, "conv_gru_launch": n, "motion_launch": n, "gru1632_launch": n,
        "_chain": 7}
