"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without CUDA. These import no JAX, so they
run on a machine with the card but no JAX, without the repo's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Shapes are small and ragged (pixel counts that are not a multiple of the
kernels' 128-pixel tile, B=2, narrow channels) to reach the edge handling
that the main path's shapes in chip_smoke.py do not. Tolerances as in
chip_smoke.py: a bf16 rounding one ulp apart in an intermediate carries
into the outputs, |err| <= 2^-5 for h', 2^-5 of the RMS of the head's x
delta, and 2^-5 of max(1, max|fused|) for the motion encoder's fused
channels; the flow channels it copies are exact.
"""

import pytest
import torch

from raft_stereo_tpu_torch.corr import reg_cuda
from raft_stereo_tpu_torch.models.layers import init_weights
from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
from raft_stereo_tpu_torch.ops import stream


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


def _modules_on(device, ch, cin, seed):
    gru, head, enc = ConvGRU(ch, cin), FlowHead(ch, 256, 2), BasicMotionEncoder(36)
    for i, m in enumerate((gru, head, enc)):
        init_weights(m, torch.Generator().manual_seed(seed + i))
    return gru.to(device), head.to(device), enc.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,ch,parts", [(2, 7, 13, 64, (64, 32)),
                                            (1, 5, 130, 32, (32,)),
                                            (1, 24, 78, 128, (128,))])
def test_gpu_conv_gru_kernel_matches_plain(cuda, b, h, w, ch, parts):
    gru, head, _ = _modules_on(cuda, ch, sum(parts), 10)
    g = torch.Generator(device=cuda).manual_seed(0)
    bf = torch.bfloat16
    hst = (torch.randn((b, h, w, ch), generator=g, device=cuda) * 0.5).to(bf)
    xs = [torch.randn((b, h, w, c), generator=g, device=cuda).to(bf) for c in parts]
    ctx = [(torch.randn((b, h, w, ch), generator=g, device=cuda) * 0.3).to(bf)
           for _ in range(3)]
    with torch.no_grad():
        wts, hw = stream.gru_weights(gru, bf), stream.head_weights(head, bf)
        czrq = stream.prepare_gru_context(gru, ctx, bf)
        got_h, got_dx = stream.fused_conv_gru(wts, hst, czrq, *xs, head=hw)
        ref_h, ref_dx = stream.conv_gru_plain(wts, hst, czrq, *xs, head=hw)
    torch.cuda.synchronize()
    assert float((got_h.float() - ref_h.float()).abs().max()) <= 2.0 ** -5
    assert float((got_dx - ref_dx).abs().max()) <= 2.0 ** -5 * float(
        ref_dx.square().mean().sqrt())


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w", [(2, 7, 13), (1, 96, 312)])
def test_gpu_motion_kernel_matches_plain(cuda, b, h, w):
    _, _, enc = _modules_on(cuda, 32, 32, 20)
    g = torch.Generator(device=cuda).manual_seed(1)
    bf = torch.bfloat16
    corr = torch.randn((b, h, w, 36), generator=g, device=cuda).to(bf)
    flow = torch.cat([torch.randn((b, h, w, 1), generator=g, device=cuda) * 3,
                      torch.zeros((b, h, w, 1), device=cuda)], -1).to(bf)
    with torch.no_grad():
        wts = stream.motion_weights(enc, bf)
        got = stream.fused_motion(wts, flow, corr)
        ref = stream.motion_plain(wts, flow, corr)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref[..., :126].float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= 2.0 ** -5 * scale
    assert torch.equal(got[..., 126:], flow)


@pytest.mark.gpu
def test_gpu_kernels_reject_what_they_do_not_take(cuda):
    gru, head, _ = _modules_on(cuda, 32, 32, 30)
    with torch.no_grad():
        wts = stream.gru_weights(gru, torch.bfloat16)
    h = torch.zeros((1, 8, 8, 32), device=cuda)  # fp32: the kernel takes bf16 only
    czrq = torch.zeros((1, 8, 8, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        stream.fused_conv_gru(wts, h, czrq, h.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,levels,radius", [(2, 3, 37, 4, 4), (1, 5, 20, 2, 3)])
def test_gpu_lookup_kernel_matches_plain_exactly(cuda, dtype, b, h, w, levels, radius):
    g = torch.Generator(device=cuda).manual_seed(2)
    f1 = torch.randn((b, h, w, 16), generator=g, device=cuda).to(dtype)
    f2 = torch.randn((b, h, w, 16), generator=g, device=cuda).to(dtype)
    ops = reg_cuda.build_corr_operands(f1, f2, num_levels=levels, radius=radius)
    coords = torch.rand((b, h, w), generator=g, device=cuda) * (w + 20) - 10
    got = reg_cuda.lookup(ops, coords)
    ref = reg_cuda.lookup_plain(ops, coords)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.gpu
def test_gpu_motion_kernel_integer_exact(cuda):
    """Small integer weights and inputs keep every fp32 sum exact in any
    order, and each bf16 rounding then acts on the same exact value: the
    kernel must equal its plain version bit for bit. Tests the engine's tap
    offsets, image borders, per-tile channel ranges and output columns."""
    _, _, enc = _modules_on(cuda, 32, 32, 40)
    g = torch.Generator(device=cuda).manual_seed(3)

    def ints(shape, lo=-1, hi=2):
        return torch.randint(lo, hi, shape, generator=g, device=cuda).float()

    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(ints(p.shape))
        wts = stream.motion_weights(enc, torch.bfloat16)
        b, h, w = 2, 9, 70
        corr = ints((b, h, w, 36), -3, 4).to(torch.bfloat16)
        flow = torch.cat([ints((b, h, w, 1), -3, 4), torch.zeros((b, h, w, 1), device=cuda)],
                         -1).to(torch.bfloat16)
        got = stream.fused_motion(wts, flow, corr)
        ref = stream.motion_plain(wts, flow, corr)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
