"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without CUDA. These import no JAX, so they
run on a machine with the card but no JAX, without the repo's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Shapes are small and ragged (maps that are not a multiple of the loop
engine's 8 x 16 output patch, B=2, narrow channels) to reach the edge
handling that the main path's shapes in chip_smoke.py do not. Tolerances as in chip_smoke.py: a bf16 rounding one
ulp apart in an intermediate carries into the outputs, |err| <= 2^-5 for
h', 2^-5 of the RMS of the head's x delta, and 2^-5 of max(1, max|fused|)
for the motion encoder's fused channels; the flow channels it copies are
exact.

The gru16+32 and resident kernels must besides equal, bit for bit, the
serial CUDA chain they replace (the same stage code); at the main path's
shapes a block of their persistent grid runs several tiles a stage. The
loop engine's edge cases (maps under one 8 x 16 output patch and off its
multiples, B = 2, no, one and two x2 parts with a 32-channel one) run all
four resident modes against their serial chains, and the motion and gru08
+ head launches against their plain versions.
With integer inputs they must also equal their plain versions wherever no
sigmoid or tanh sits between (those are the card's and the library's own
functions, which may round their last fp32 bit apart).

The encoder kernels (``ops/encoder.py``: stem, 3x3 pass, point3, point2) are
held to 1 bf16 ulp of their plain versions (an fp32 sum in another order can
put the one rounding on the other side), their statistics to 1e-5 of the
plain version's fp64 sums, and two runs to the same bits; with integer
inputs, where every sum is exact, to equality. The pass's edge cases (maps
smaller than its 8 x 16 output patch and off its multiples, a half-empty or
a third 64-channel chunk, one or two column blocks) are held to equality on
integer inputs: at a single pixel the statistics are single values, and an
fp32 sum with cancellation in another order has no 1e-5 bound there.

The alt kernel is held to 1 bf16 ulp (1e-5 of the largest tap in fp32) of
its plain version, whose fp32 row product sums in another order, also at
its windowed design's edges (a tile's coordinates spread over the whole
row, clustered, at the row's ends, or apart row by row; D at the kernel's
limits), two runs with equal bits; the lookup's int8 mode (RAFT_CORR_PACK8)
to equality, and the resident kernel on int8 levels bit for bit to the
serial int8 chain. The stem's 8 x 64 patch edges, with and without TMA,
are held to equality on integer inputs.

The int8 context lanes (RAFT_LANE_PACK8): the three GRU kernels on an int8
czrq container are held to their plain versions with the bf16 mode's
tolerances, and the two persistent ones bit for bit to the serial lane8
chain (the resident kernel in all four instantiations: bf16 or int8 levels
by bf16 or int8 czrq). The quantize-on-exit pass and point2 must equal, bit
for bit, the host quantization (``quantize_feature8``) of the same kernel's
bf16 output, and stay within two quantization steps of the plain version's
(one bf16 ulp apart in a value or in the amax moves q by about one step
each).
"""

import pytest
import torch

from raft_stereo_tpu_torch.corr import alt_cuda, reg_cuda
from raft_stereo_tpu_torch.corr.reg_cuda import Lane8, quantize_feature8
from raft_stereo_tpu_torch.models.layers import init_weights
from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
from raft_stereo_tpu_torch.ops import encoder as enc
from raft_stereo_tpu_torch.ops import resident, stream
from raft_stereo_tpu_torch.ops.resize import interp_align_corners


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
@pytest.mark.parametrize("head_on", [True, False])
@pytest.mark.parametrize("b,h,w,ch,parts", [(2, 7, 13, 64, (64, 32)),
                                            (1, 5, 130, 32, (32,)),
                                            (1, 6, 20, 32, (32, 64, 32)),
                                            (1, 24, 78, 128, (128,)),
                                            (2, 9, 17, 128, (32, 128)),
                                            (1, 48, 156, 128, (128, 128))])
def test_gpu_conv_gru_kernel_matches_plain(cuda, b, h, w, ch, parts, head_on):
    """The ConvGRU step with the head (gru08) and without (the gru16 and
    gru32 steps), all on the loop engine."""
    gru, head, _ = _modules_on(cuda, ch, sum(parts), 10)
    g = torch.Generator(device=cuda).manual_seed(0)
    bf = torch.bfloat16
    hst = (torch.randn((b, h, w, ch), generator=g, device=cuda) * 0.5).to(bf)
    xs = [torch.randn((b, h, w, c), generator=g, device=cuda).to(bf) for c in parts]
    ctx = [(torch.randn((b, h, w, ch), generator=g, device=cuda) * 0.3).to(bf)
           for _ in range(3)]
    with torch.no_grad():
        wts = stream.gru_weights(gru, bf)
        hw = stream.head_weights(head, bf) if head_on else None
        czrq = stream.prepare_gru_context(gru, ctx, bf)
        got_h, got_dx = stream.fused_conv_gru(wts, hst, czrq, *xs, head=hw)
        ref_h, ref_dx = stream.conv_gru_plain(wts, hst, czrq, *xs, head=hw)
    torch.cuda.synchronize()
    assert float((got_h.float() - ref_h.float()).abs().max()) <= 2.0 ** -5
    if not head_on:
        assert got_dx is None and ref_dx is None
        return
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


def _edge_coords(g, b, h, w, radius, device):
    """x positions spread past both ends of the row, with the first pixel of
    the map far left and the last far right, so the windows reach the first
    and the last bytes of every level tensor."""
    coords = torch.rand((b, h, w), generator=g, device=device) * (w + 4 * radius + 8) \
        - (2 * radius + 4)
    coords[0, 0, 0] = -(2 * radius + 3.5)
    coords[-1, -1, -1] = w + 2 * radius + 3.5
    return coords


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8"])
@pytest.mark.parametrize("w", [13, 37, 39])
@pytest.mark.parametrize("radius", [1, 4])
def test_gpu_lookup_kernel_window_edges(cuda, monkeypatch, kind, w, radius):
    """The vector window gather at rows whose bytes are not a multiple of
    16 (26, 74, 78 bf16; 13, 37, 39 int8), levels narrower than the window
    (w = 13: 13, 6, 3, 1), B = 2 with a scale a sample under pack8, and
    windows past the first and the last byte of each level tensor: exactly
    the plain version's taps."""
    monkeypatch.setenv("RAFT_CORR_PACK8", "1" if kind == "int8" else "0")
    g = torch.Generator(device=cuda).manual_seed(130 + w + radius)
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    f1 = torch.randn((2, 3, w, 16), generator=g, device=cuda).to(dtype)
    f2 = torch.randn((2, 3, w, 16), generator=g, device=cuda).to(dtype)
    f1[1] *= 7.0  # another scale for the second sample
    ops = reg_cuda.build_corr_operands(f1, f2, num_levels=4, radius=radius)
    assert ops.pack8 == (kind == "int8")
    coords = _edge_coords(g, 2, 3, w, radius, cuda)
    got = reg_cuda.lookup(ops, coords)
    ref = reg_cuda.lookup_plain(ops, coords)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.gpu
def test_gpu_lookup_follows_replaced_levels(cuda):
    """The kernel's level arguments are built once for a CorrOperands and
    reused; replacing its levels rebuilds them."""
    g = torch.Generator(device=cuda).manual_seed(137)
    f1, f2, f3 = (torch.randn((1, 4, 37, 16), generator=g, device=cuda).bfloat16()
                  for _ in range(3))
    ops = reg_cuda.build_corr_operands(f1, f2, num_levels=4, radius=4)
    for _ in range(3):
        coords = _edge_coords(g, 1, 4, 37, 4, cuda)
        assert torch.equal(reg_cuda.lookup(ops, coords), reg_cuda.lookup_plain(ops, coords))
    ops.levels = reg_cuda.build_corr_operands(f1, f3, num_levels=4, radius=4).levels
    coords = _edge_coords(g, 1, 4, 37, 4, cuda)
    got = reg_cuda.lookup(ops, coords)
    assert torch.equal(got, reg_cuda.lookup_plain(ops, coords))
    ops.levels[2] = ops.levels[2] * 2.0
    assert torch.equal(reg_cuda.lookup(ops, coords), reg_cuda.lookup_plain(ops, coords))


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


def _gru1632_case(device, b, h16, w16, ch, seed, ints=False, cx0=None):
    """gru16+32 arguments; x0p, the pooled finer state, of ``cx0``
    channels (default ``ch``)."""
    cx0 = ch if cx0 is None else cx0
    h32, w32 = h16 // 2, w16 // 2
    g16, g32 = ConvGRU(ch, cx0 + ch), ConvGRU(ch, ch)
    for i, m in enumerate((g16, g32)):
        init_weights(m, torch.Generator().manual_seed(seed + i))
    g16, g32 = g16.to(device), g32.to(device)
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape, scale):
        if ints:
            return torch.randint(-1, 2, shape, generator=g, device=device).to(torch.bfloat16)
        return (torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)

    bf = torch.bfloat16
    with torch.no_grad():
        if ints:
            for p in (*g16.parameters(), *g32.parameters()):
                p.copy_(torch.randint(-1, 2, p.shape, generator=g, device=device).float())
        w16_, w32_ = stream.gru_weights(g16, bf, "gru16"), stream.gru_weights(g32, bf, "gru32")
        czrq16 = stream.prepare_gru_context(g16, [rnd((b, h16, w16, ch), 0.3)] * 3, bf)
        czrq32 = stream.prepare_gru_context(g32, [rnd((b, h32, w32, ch), 0.3)] * 3, bf)
    args = (w16_, w32_, rnd((b, h16, w16, ch), 0.5), rnd((b, h32, w32, ch), 0.5), czrq16, czrq32,
            rnd((b, h16, w16, cx0), 1.0), rnd((b, h32, w32, ch), 1.0))
    return args


def _gru1632_serial(w16, w32, h16, h32, czrq16, czrq32, x0p, x1p):
    h32n, _ = stream.fused_conv_gru(w32, h32, czrq32, x1p)
    up = interp_align_corners(h32n, tuple(h16.shape[1:3]))
    h16n, _ = stream.fused_conv_gru(w16, h16, czrq16, x0p, up)
    return h16n, h32n


def _assert_steps_within_band(w16, w32, h16, h32, czrq16, czrq32, x0p, x1p):
    """Each head-less step of the serial chain (the loop engine's launches)
    within 2^-5 of its plain version on the same inputs."""
    h32n, _ = stream.fused_conv_gru(w32, h32, czrq32, x1p)
    ref32, _ = stream.conv_gru_plain(w32, h32, czrq32, x1p)
    up = interp_align_corners(h32n, tuple(h16.shape[1:3]))
    h16n, _ = stream.fused_conv_gru(w16, h16, czrq16, x0p, up)
    ref16, _ = stream.conv_gru_plain(w16, h16, czrq16, x0p, up)
    torch.cuda.synchronize()
    assert float((h32n.float() - ref32.float()).abs().max()) <= 2.0 ** -5
    assert float((h16n.float() - ref16.float()).abs().max()) <= 2.0 ** -5


# gru16+32 tilings: (B, H16, W16, ch, cx0). gru32 maps of 1x1 and 2x3, gru16
# maps off the 8 x 16 patch's multiples, B = 2, hidden widths 32, 64 and 128
# with x0p of 32 and 128 channels.
GRU1632_TILING = [(2, 10, 26, 32, 32), (1, 14, 18, 64, 64), (1, 48, 156, 128, 128),
                  (1, 2, 2, 32, 32), (2, 4, 6, 64, 128), (1, 22, 34, 128, 32),
                  (2, 18, 46, 128, 128), (1, 6, 38, 32, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h16,w16,ch,cx0", GRU1632_TILING)
def test_gpu_gru1632_kernel_matches_plain_and_serial(cuda, b, h16, w16, ch, cx0):
    args = _gru1632_case(cuda, b, h16, w16, ch, 50, cx0=cx0)
    with torch.no_grad():
        got = stream.fused_gru1632(*args)
        serial = _gru1632_serial(*args)
        plain = stream.gru1632_plain(*args)
        _assert_steps_within_band(*args)
    torch.cuda.synchronize()
    for g_, s_, p_ in zip(got, serial, plain):
        assert torch.equal(g_, s_)
        assert float((g_.float() - p_.float()).abs().max()) <= 2.0 ** -5


@pytest.mark.gpu
@pytest.mark.parametrize("b,h16,w16,ch,cx0", [(2, 12, 22, 32, 32), (1, 22, 34, 128, 32)])
def test_gpu_gru1632_kernel_integer_inputs(cuda, b, h16, w16, ch, cx0):
    """Integer weights and inputs: every conv sum of gru32's gates is an
    exact integer, so z, r (sigmoid of an integer) and r*h round alike on
    both routes; the kernel equals the serial chain bit for bit and its
    plain version within the tolerance, on all but a few elements exactly."""
    args = _gru1632_case(cuda, b, h16, w16, ch, 60, ints=True, cx0=cx0)
    with torch.no_grad():
        got = stream.fused_gru1632(*args)
        serial = _gru1632_serial(*args)
        plain = stream.gru1632_plain(*args)
    torch.cuda.synchronize()
    for g_, s_, p_ in zip(got, serial, plain):
        assert torch.equal(g_, s_)
        assert float((g_.float() - p_.float()).abs().max()) <= 2.0 ** -5
        assert float((g_ == p_).float().mean()) >= 0.99


def _resident_case(device, b, h, w, ch, seed, ints=False):
    gru, head, enc = _modules_on(device, ch, 128 + ch, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def rnd(shape, scale=1.0, lo=-1, hi=2):
        if ints:
            return torch.randint(lo, hi, shape, generator=g, device=device).to(bf)
        return (torch.randn(shape, generator=g, device=device) * scale).to(bf)

    with torch.no_grad():
        if ints:
            for p in (*gru.parameters(), *head.parameters(), *enc.parameters()):
                p.copy_(torch.randint(-1, 2, p.shape, generator=g, device=device).float())
        f1, f2 = rnd((b, h, w, 16)), rnd((b, h, w, 16))
        ops = reg_cuda.build_corr_operands(f1, f2, num_levels=4, radius=4)
        if ints:
            coords = torch.randint(-6, w + 6, (b, h, w), generator=g, device=device).float()
        else:
            coords = torch.rand((b, h, w), generator=g, device=device) * (w + 20) - 10
        flow = torch.cat([rnd((b, h, w, 1), 3.0, -3, 4),
                          torch.zeros((b, h, w, 1), device=device, dtype=bf)], -1)
        wts = (stream.motion_weights(enc, bf), stream.gru_weights(gru, bf, "gru08"),
               stream.head_weights(head, bf))
        czrq = stream.prepare_gru_context(gru, [rnd((b, h, w, ch), 0.3)] * 3, bf)
    return (*wts, ops, rnd((b, h, w, ch), 0.5), czrq, coords, flow, rnd((b, h, w, ch)))


def _resident_serial(mw, gw, hw, ops, h, czrq, coords, flow, *x2):
    corr = reg_cuda.lookup(ops, coords)
    motion = stream.fused_motion(mw, flow, corr)
    return stream.fused_conv_gru(gw, h, czrq, motion, *x2, head=hw)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,ch", [(2, 7, 13, 32), (1, 10, 45, 64), (1, 96, 312, 128)])
def test_gpu_resident_kernel_matches_plain_and_serial(cuda, b, h, w, ch):
    args = _resident_case(cuda, b, h, w, ch, 70)
    with torch.no_grad():
        got = resident.fused_iter(*args)
        serial = _resident_serial(*args)
        plain = resident.fused_iter_plain(*args)
    torch.cuda.synchronize()
    for g_, s_ in zip(got, serial):
        assert torch.equal(g_, s_)
    assert float((got[0].float() - plain[0].float()).abs().max()) <= 2.0 ** -5
    assert float((got[1] - plain[1]).abs().max()) <= 2.0 ** -5 * float(
        plain[1].square().mean().sqrt())


@pytest.mark.gpu
def test_gpu_resident_kernel_integer_inputs(cuda):
    """Integer fmaps (a volume over sqrt(16) = 4, exact), integer coords
    (each lerp returns a tap), integer weights and inputs: the gather and
    the motion stages are exact, so any tap, border or channel slip shows
    as an integer-sized error; the kernel equals the serial chain bit for
    bit and its plain version within the tolerance."""
    args = _resident_case(cuda, 2, 9, 37, 32, 80, ints=True)
    with torch.no_grad():
        got = resident.fused_iter(*args)
        serial = _resident_serial(*args)
        plain = resident.fused_iter_plain(*args)
        mw, _, _, ops, _, _, coords, flow, _ = args
        corr = reg_cuda.lookup(ops, coords)
        motion_exact = torch.equal(stream.fused_motion(mw, flow, corr),
                                   stream.motion_plain(mw, flow, corr))
    torch.cuda.synchronize()
    assert motion_exact
    for g_, s_ in zip(got, serial):
        assert torch.equal(g_, s_)
    assert float((got[0].float() - plain[0].float()).abs().max()) <= 2.0 ** -5
    assert float((got[0] == plain[0]).float().mean()) >= 0.99


# -- the encoder kernels ------------------------------------------------------------

RAGGED = [(7, 13), (5, 131), (33, 70), (3, 259)]  # odd H and W, H < 8, W off the 64-pixel tile


def _ulps(got, ref):
    g, r = got.float(), ref.float()
    mag = torch.maximum(r.abs(), r.square().mean().sqrt().clamp_min(1e-6))
    return float(((g - r).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _stats_close(got, ref, n):
    sq = ref[1].double()
    e_sum = ((got[0].double() - ref[0].double()).abs() / (n * sq).sqrt()).max()
    e_sq = ((got[1].double() - sq).abs() / sq).max()
    return float(torch.maximum(e_sum, e_sq)) <= 1e-5


def _enc_conv(device, cin, cout, k, seed, bias=True, ints=False):
    g = torch.Generator().manual_seed(seed)
    if ints:
        w = torch.randint(-1, 2, (cout, cin, k, k), generator=g).float()
        b = torch.randint(-2, 3, (cout,), generator=g).float()
    else:
        w = torch.randn((cout, cin, k, k), generator=g) * (2.0 / (cout * k * k)) ** 0.5
        b = torch.rand((cout,), generator=g) - 0.5
    return w.to(device), (b.to(device) if bias else None)


def _enc_triple(device, g, shape, with_mv, ints=False):
    if ints:
        raw = torch.randint(-3, 4, shape, generator=g, device=device).to(torch.bfloat16)
    else:
        raw = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    if not with_mv:
        return raw, None, None
    c = shape[-1]
    if ints:  # a power-of-two inv and an integer mean keep the transform exact
        return (raw, torch.randint(-1, 2, (c,), generator=g, device=device).float(),
                torch.full((c,), 0.5, device=device))
    return (raw, torch.randn(c, generator=g, device=device) * 0.3,
            torch.rand(c, generator=g, device=device) * 1.5 + 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("h,w", RAGGED + [(64, 96)])
def test_gpu_stem_kernel_matches_plain(cuda, h, w, stats):
    g = torch.Generator(device=cuda).manual_seed(90)
    x = (torch.rand((1, h, w, 3), generator=g, device=cuda) * 2 - 1).to(torch.bfloat16)
    wt, b = _enc_conv(cuda, 3, 64, 7, 91)
    got, st = enc.stem(x, wt, b, stats=stats)
    again, st2 = enc.stem(x, wt, b, stats=stats)
    ref, st_ref = enc.stem_plain(x, wt, b, stats=stats)
    torch.cuda.synchronize()
    assert _ulps(got, ref) <= 1.0 and torch.equal(got, again)
    if stats:
        assert _stats_close(st, st_ref, h * w) and torch.equal(st, st2)
    else:
        assert st is None


@pytest.mark.gpu
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("kind", ["raw1", "mid1", "mid2"])
@pytest.mark.parametrize("h,w,cin,cout", [(7, 13, 64, 64), (5, 131, 96, 96), (33, 70, 128, 128),
                                          (3, 259, 128, 32), (9, 20, 32, 160)])
def test_gpu_pass_kernel_matches_plain(cuda, h, w, cin, cout, kind, stats):
    g = torch.Generator(device=cuda).manual_seed(92)
    inputs = [_enc_triple(cuda, g, (1, h, w, cin), stats and kind != "raw1")
              for _ in range(2 if kind == "mid2" else 1)]
    wt, b = _enc_conv(cuda, cin, cout, 3, 93)
    got, st = enc.conv_pass(kind, inputs, wt, b, stats=stats)
    again, st2 = enc.conv_pass(kind, inputs, wt, b, stats=stats)
    ref, st_ref = enc.conv_pass_plain(kind, inputs, wt, b, stats=stats)
    torch.cuda.synchronize()
    assert _ulps(got, ref) <= 1.0 and torch.equal(got, again)
    if stats:
        assert _stats_close(st, st_ref, h * w) and torch.equal(st, st2)
    else:
        assert st is None


EDGES = [(1, 1, 32, 96), (2, 130, 160, 384), (70, 3, 32, 384), (19, 37, 160, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("kind", ["raw1", "mid1", "mid2"])
@pytest.mark.parametrize("h,w,cin,cout", EDGES)
def test_gpu_pass_kernel_patch_edges_and_widths(cuda, h, w, cin, cout, kind, stats):
    """Maps smaller than the kernel's 8 x 16 output patch and not a multiple
    of it, 32 and 160 input channels (one chunk of 64 half empty, three
    chunks), and 96 and 384 output channels (one block of 96 columns, two of
    192), on integer inputs, weights and means (inv = 1/2), where every sum
    is exact: outputs and statistics equal the plain version's bit for bit,
    so a wrong tap, halo, chunk or column shows. The plan's statistics rows
    are one per patch (maps this small need no scratch rows for the fp64
    reduction)."""
    g = torch.Generator(device=cuda).manual_seed(121)
    inputs = [_enc_triple(cuda, g, (1, h, w, cin), stats and kind != "raw1", ints=True)
              for _ in range(2 if kind == "mid2" else 1)]
    wt, b = _enc_conv(cuda, cin, cout, 3, 122, ints=True)
    got, st = enc.conv_pass(kind, inputs, wt, b, stats=stats)
    again, st2 = enc.conv_pass(kind, inputs, wt, b, stats=stats)
    ref, st_ref = enc.conv_pass_plain(kind, inputs, wt, b, stats=stats)
    torch.cuda.synchronize()
    rows, width, smem, blocks = enc.pass_plan(kind, h, w, cin, cout)
    assert rows == -(-h // 8) * -(-w // 16) and width == (96 if cout == 96 else 192)
    assert 1 <= blocks <= (2 if width == 96 else 1) and blocks * smem <= 228 * 1024
    assert torch.equal(got, ref) and torch.equal(got, again)
    if stats:
        assert torch.equal(st, st_ref) and torch.equal(st, st2)
    else:
        assert st is None


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["raw1", "mid1", "mid2"])
@pytest.mark.parametrize("h,w,cin,cout", EDGES)
def test_gpu_pass_kernel_patch_edges_on_random_inputs(cuda, h, w, cin, cout, kind):
    """The same shapes on random inputs and means, instance norm: outputs
    within 1 bf16 ulp of the plain version, two runs with equal bits."""
    g = torch.Generator(device=cuda).manual_seed(125)
    inputs = [_enc_triple(cuda, g, (1, h, w, cin), kind != "raw1")
              for _ in range(2 if kind == "mid2" else 1)]
    wt, b = _enc_conv(cuda, cin, cout, 3, 126)
    got, st = enc.conv_pass(kind, inputs, wt, b, stats=True)
    again, st2 = enc.conv_pass(kind, inputs, wt, b, stats=True)
    ref, _ = enc.conv_pass_plain(kind, inputs, wt, b, stats=True)
    torch.cuda.synchronize()
    assert _ulps(got, ref) <= 1.0 and torch.equal(got, again) and torch.equal(st, st2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["raw1", "mid1"])
def test_gpu_pass_kernel_without_a_bias(cuda, kind):
    g = torch.Generator(device=cuda).manual_seed(94)
    inputs = [_enc_triple(cuda, g, (1, 6, 21, 64), kind == "mid1")]
    wt, _ = _enc_conv(cuda, 64, 96, 3, 95, bias=False)
    got, st = enc.conv_pass(kind, inputs, wt, None, stats=True)
    ref, st_ref = enc.conv_pass_plain(kind, inputs, wt, None, stats=True)
    torch.cuda.synchronize()
    assert _ulps(got, ref) <= 1.0 and _stats_close(st, st_ref, 6 * 21)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,stats", [("raw1", True), ("mid1", False), ("mid1", True),
                                        ("mid2", False), ("mid2", True)])
def test_gpu_pass_kernel_integer_exact(cuda, kind, stats):
    """Small integer weights, inputs and means with inv = 1/2 keep every
    transform and every fp32 sum exact in any order: outputs and statistics
    must equal the plain version's bit for bit. A wrong tap, border (a tap
    outside the image must read 0, not the transform of 0: the means are
    not 0 here), channel chunk or output column shows as an integer."""
    g = torch.Generator(device=cuda).manual_seed(96)
    h, w, cin, cout = 9, 37, 96, 96
    inputs = [_enc_triple(cuda, g, (1, h, w, cin), stats and kind != "raw1", ints=True)
              for _ in range(2 if kind == "mid2" else 1)]
    wt, b = _enc_conv(cuda, cin, cout, 3, 97, ints=True)
    got, st = enc.conv_pass(kind, inputs, wt, b, stats=stats)
    ref, st_ref = enc.conv_pass_plain(kind, inputs, wt, b, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if stats:
        assert torch.equal(st, st_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(5, 40), (6, 64), (7, 65), (9, 72), (3, 13), (17, 136),
                                 (1, 8)])
def test_gpu_stem_kernel_patch_edges_integer_exact(cuda, h, w):
    """The stem's 8 x 64 output patches: maps under one patch's height or
    width and one column past a patch (w = 65, 72, 136), with widths whose
    rows TMA takes (w a multiple of 8) and whose rows the block loads
    itself; integer inputs and weights, where every sum is exact: outputs
    and statistics equal the plain version's, and the plan's partial rows
    are one a block of the kernel's constant grid."""
    g = torch.Generator(device=cuda).manual_seed(103)
    x = torch.randint(-2, 3, (1, h, w, 3), generator=g, device=cuda).to(torch.bfloat16)
    wt, b = _enc_conv(cuda, 3, 64, 7, 104, ints=True)
    got, st = enc.stem(x, wt, b, stats=True)
    again, st2 = enc.stem(x, wt, b, stats=True)
    ref, st_ref = enc.stem_plain(x, wt, b, stats=True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(st, st_ref)
    assert torch.equal(got, again) and torch.equal(st, st2)
    rows, k, tap_row = enc.stem_plan(h, w)
    assert rows == min(-(-h // 8) * -(-w // 64), 132) and (k, tap_row) == (160, 22)


@pytest.mark.gpu
def test_gpu_stem_kernel_integer_exact(cuda):
    g = torch.Generator(device=cuda).manual_seed(98)
    h, w = 11, 45
    x = torch.randint(-2, 3, (1, h, w, 3), generator=g, device=cuda).to(torch.bfloat16)
    wt, b = _enc_conv(cuda, 3, 64, 7, 99, ints=True)
    got, st = enc.stem(x, wt, b, stats=True)
    ref, st_ref = enc.stem_plain(x, wt, b, stats=True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(st, st_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("h,w,ch", [(7, 13, 64), (5, 131, 96), (3, 259, 128), (2, 3, 8)])
def test_gpu_point_kernels_match_plain(cuda, h, w, ch, norm):
    g = torch.Generator(device=cuda).manual_seed(100)
    shape = (1, h, w, ch)
    s, y2, y4 = (_enc_triple(cuda, g, shape, True) for _ in range(3))
    got3, ref3 = enc.point3(s, y2, y4, norm=norm), enc.point3_plain(s, y2, y4, norm=norm)
    x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    got2, ref2 = enc.point2(x, y2, norm=norm), enc.point2_plain(x, y2, norm=norm)
    torch.cuda.synchronize()
    assert _ulps(got3, ref3) <= 1.0 and torch.equal(got3, enc.point3(s, y2, y4, norm=norm))
    assert _ulps(got2, ref2) <= 1.0 and torch.equal(got2, enc.point2(x, y2, norm=norm))


@pytest.mark.gpu
def test_gpu_encoder_kernels_reject_what_they_do_not_take(cuda):
    wt, b = _enc_conv(cuda, 64, 64, 3, 101)
    x = torch.zeros((1, 8, 8, 64), device=cuda)  # fp32: the kernels take bf16 only
    with pytest.raises(TypeError):
        enc.conv_pass("raw1", [(x, None, None)], wt, b, stats=False)
    xb = torch.zeros((2, 8, 8, 64), device=cuda, dtype=torch.bfloat16)  # B = 2
    with pytest.raises(ValueError):
        enc.conv_pass("raw1", [(xb, None, None)], wt, b, stats=False)
    with pytest.raises(ValueError):  # instance norm without the statistics
        enc.conv_pass("mid1", [(xb[:1], None, None)], wt, b, stats=True)


@pytest.mark.gpu
def test_gpu_encoder_launches_are_counted_by_variant(cuda):
    """The feature net's chain counts under the instance-norm variants and
    the context net's under the folded-BatchNorm ones, each launch once."""
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.models.extractor import BasicEncoder
    from raft_stereo_tpu_torch.models.layers import init_weights
    nets = {}
    for norm_fn in ("instance", "batch"):
        net = BasicEncoder(output_dim=256, norm_fn=norm_fn, downsample=2)
        init_weights(net, torch.Generator().manual_seed(102))
        nets[norm_fn] = net.to(cuda).eval()
    fnet = nets["instance"]
    x = torch.zeros((1, 16, 24, 3), device=cuda, dtype=torch.bfloat16)
    kernels.reset_launches()
    with torch.no_grad():
        enc.fused_in_stem_layer1(fnet, x)
        enc.stream_resblock(fnet.layer2[1], torch.zeros((1, 8, 12, 96), device=cuda,
                                                        dtype=torch.bfloat16), "instance")
        enc.fused_stem_layer1(nets["batch"], x)
    torch.cuda.synchronize()
    assert kernels.variants == {
        "enc_stem:instance": 1, "enc_pass:mid1/instance/64": 3, "enc_pass:mid2/instance/64": 1,
        "enc_point3:instance/64": 1, "enc_pass:raw1/instance/96": 1,
        "enc_pass:mid1/instance/96": 1, "enc_point2:instance/96": 1,
        "enc_stem:bn": 1, "enc_pass:mid1/bn/64": 3, "enc_pass:mid2/bn/64": 1,
        "enc_point3:bn/64": 1}
    assert kernels.launches == {"enc_stem": 2, "enc_pass": 10, "enc_point3": 2, "enc_point2": 1}


# -- the alt kernel and the int8 correlation (RAFT_CORR_PACK8) ----------------------


def _ulps_of(got, ref):
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    return float(((got.float() - r).abs() / ulp).max())


def _hold_alt(got, ref, again, dtype):
    """fp32 within 1e-5 of the largest tap, bf16 within one ulp of each
    value; two runs with equal bits."""
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.equal(got, again)
    if dtype == torch.float32:
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert _ulps_of(got, ref) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w1,w2,d,levels,radius", [
    (2, 3, 37, 37, 16, 4, 4), (1, 5, 200, 131, 24, 3, 2), (1, 2, 312, 312, 256, 4, 4),
    (1, 1, 9, 5, 512, 2, 1), (1, 3, 40, 40, 64, 2, 7)])
def test_gpu_alt_kernel_matches_plain(cuda, dtype, b, h, w1, w2, d, levels, radius):
    """The alt kernel sums each dot in another order than the plain
    version's fp32 matmul: fp32 within 1e-5 of the largest tap, bf16 within
    one ulp of each value (the one downcast may land on the other side).
    Positions far off the row give exact zeros; ragged widths, a level
    narrower than the radius, D from 16 to 512, radius 1 to 7 (the most the
    kernel takes)."""
    g = torch.Generator(device=cuda).manual_seed(90)
    f1 = torch.randn((b, h, w1, d), generator=g, device=cuda).to(dtype)
    f2 = torch.randn((b, h, w2, d), generator=g, device=cuda).to(dtype)
    ops = alt_cuda.build_alt_operands(f1, f2, num_levels=levels, radius=radius)
    coords = torch.rand((b, h, w1), generator=g, device=cuda) * (w2 + 20) - 10
    flat = coords.view(-1)
    flat[::10], flat[5::10] = -1e6, 1e6
    got = alt_cuda.lookup(ops, coords)
    ref = alt_cuda.lookup_plain(ops, coords)
    assert torch.equal(got.view(-1, got.shape[-1])[::5], torch.zeros_like(ref.view(
        -1, ref.shape[-1])[::5]))
    _hold_alt(got, ref, alt_cuda.lookup(ops, coords), dtype)


def _alt_coords(case, g, b, h, w1, w2, device):
    """x positions that put the kernel's windows (a tile of 64 pixels of a
    row, its taps' positions walked in chunks of 64 at bf16, 32 or 16 at
    fp32) where a case wants them."""
    col = torch.arange(w1, device=device, dtype=torch.float32).expand(b, h, w1)
    noise = torch.rand((b, h, w1), generator=g, device=device)
    if case == "spread":  # every tile's window the whole row: several chunks a level
        return noise * (w2 + 20) - 10
    if case == "clustered_and_spread":  # most of a tile within 3 px, every 16th anywhere
        x = 0.3 * w2 + 3 * noise
        x[..., ::16] = noise[..., ::16] * (w2 + 20) - 10
        return x
    if case == "row_ends":  # the first tile at the row's left end, the rest at its right
        x = w2 - 8 + 14 * noise
        x[..., :64] = -6 + 14 * noise[..., :64]
        return x
    # "rows_apart": a frame-like field, shifted and stretched row by row and
    # sample by sample, so each row of the batch has windows of its own.
    r = torch.arange(b * h, device=device, dtype=torch.float32).reshape(b, h, 1)
    return col * (0.5 + 0.25 * r) - 3 * r + 4 * noise - 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float32, 64),
                                     (torch.bfloat16, 1024), (torch.float32, 512)])
@pytest.mark.parametrize("case", ["spread", "clustered_and_spread", "row_ends", "rows_apart"])
def test_gpu_alt_kernel_windows(cuda, dtype, d, case):
    """The windowed design's edges: w1 not a multiple of the 64-pixel tile,
    windows over several chunks, one tile with clustered and spread
    coordinates, windows at both ends of the row, rows of one batch with
    windows of their own, and D at the kernel's limits (1024 bf16, 512
    fp32): within the plain version's tolerance, equal bits in two runs."""
    g = torch.Generator(device=cuda).manual_seed(95)
    b, h, w1, w2 = (2, 3, 100, 300) if d <= 64 else (1, 2, 70, 90)
    f1 = torch.randn((b, h, w1, d), generator=g, device=cuda).to(dtype)
    f2 = torch.randn((b, h, w2, d), generator=g, device=cuda).to(dtype)
    ops = alt_cuda.build_alt_operands(f1, f2, num_levels=4, radius=4)
    coords = _alt_coords(case, g, b, h, w1, w2, cuda)
    got = alt_cuda.lookup(ops, coords)
    _hold_alt(got, alt_cuda.lookup_plain(ops, coords), alt_cuda.lookup(ops, coords), dtype)


@pytest.mark.gpu
def test_gpu_alt_kernel_rejects_what_it_does_not_take(cuda):
    f = torch.zeros((1, 2, 8, 12), device=cuda, dtype=torch.bfloat16)  # D = 12
    ops = alt_cuda.build_alt_operands(f, f, num_levels=2, radius=2)
    with pytest.raises(ValueError):
        alt_cuda.lookup(ops, torch.zeros((1, 2, 8), device=cuda))
    f = torch.zeros((1, 2, 8, 16), device=cuda, dtype=torch.bfloat16)
    ops = alt_cuda.build_alt_operands(f, f, num_levels=2, radius=8)  # 18 dots a level
    with pytest.raises(ValueError):
        alt_cuda.lookup(ops, torch.zeros((1, 2, 8), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,levels,radius", [(2, 3, 37, 4, 4), (1, 5, 20, 2, 3),
                                                 (1, 96, 312, 4, 4)])
def test_gpu_pack8_lookup_matches_plain_exactly(cuda, monkeypatch, b, h, w, levels, radius):
    """int8 levels: the kernel's dequant, mask and lerp are the plain
    version's fp32 operations in the same order, so bit for bit; counted as
    corr_lookup and as its pack8 variant."""
    from raft_stereo_tpu_torch import kernels
    monkeypatch.setenv("RAFT_CORR_PACK8", "1")
    g = torch.Generator(device=cuda).manual_seed(91)
    f1 = torch.randn((b, h, w, 16), generator=g, device=cuda).bfloat16()
    f2 = torch.randn((b, h, w, 16), generator=g, device=cuda).bfloat16()
    f1[-1] *= 9.0  # another scale for the last sample
    ops = reg_cuda.build_corr_operands(f1, f2, num_levels=levels, radius=radius)
    assert ops.pack8
    coords = torch.rand((b, h, w), generator=g, device=cuda) * (w + 20) - 10
    kernels.reset_launches()
    got = reg_cuda.lookup(ops, coords)
    ref = reg_cuda.lookup_plain(ops, coords)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    assert kernels.launches == {"corr_lookup": 1}
    assert kernels.variants == {"corr_lookup:pack8": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,ch", [(2, 7, 13, 32), (1, 96, 312, 128)])
def test_gpu_resident_pack8_matches_serial_bitwise(cuda, monkeypatch, b, h, w, ch):
    """The resident kernel on int8 levels gathers with the lookup's own
    body: bit for bit the serial pack8 chain, and within the tolerance of
    its plain version."""
    from raft_stereo_tpu_torch import kernels
    monkeypatch.setenv("RAFT_CORR_PACK8", "1")
    args = _resident_case(cuda, b, h, w, ch, 92)
    assert args[3].pack8
    kernels.reset_launches()
    with torch.no_grad():
        got = resident.fused_iter(*args)
        serial = _resident_serial(*args)
        plain = resident.fused_iter_plain(*args)
    torch.cuda.synchronize()
    for g_, s_ in zip(got, serial):
        assert torch.equal(g_, s_)
    assert float((got[0].float() - plain[0].float()).abs().max()) <= 2.0 ** -5
    assert float((got[1] - plain[1]).abs().max()) <= 2.0 ** -5 * float(
        plain[1].square().mean().sqrt())
    assert kernels.variants["fused_iter:pack8"] == 1
    assert kernels.variants["corr_lookup:pack8"] == 1


# -- the int8 context lanes (RAFT_LANE_PACK8) -------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("head_on", [True, False])
@pytest.mark.parametrize("b,h,w,ch,parts", [(2, 7, 13, 64, (64, 32)), (1, 24, 78, 128, (128,))])
def test_gpu_conv_gru_lane8_matches_plain(cuda, b, h, w, ch, parts, head_on):
    """The ConvGRU kernel on an int8 czrq, with the head and without; the
    per-sample scale (sample 1 at 9x the contrast) picked by the pixel's
    sample."""
    from raft_stereo_tpu_torch import kernels
    gru, head, _ = _modules_on(cuda, ch, sum(parts), 110)
    g = torch.Generator(device=cuda).manual_seed(111)
    bf = torch.bfloat16
    hst = (torch.randn((b, h, w, ch), generator=g, device=cuda) * 0.5).to(bf)
    xs = [torch.randn((b, h, w, c), generator=g, device=cuda).to(bf) for c in parts]
    ctx = [(torch.randn((b, h, w, ch), generator=g, device=cuda) * 0.3) for _ in range(3)]
    ctx[0][-1] *= 9.0
    with torch.no_grad():
        wts = stream.gru_weights(gru, bf, "gru08")
        hw = stream.head_weights(head, bf) if head_on else None
        lane = quantize_feature8(stream.prepare_gru_context(gru, [c.to(bf) for c in ctx], bf))
        kernels.reset_launches()
        got_h, got_dx = stream.fused_conv_gru(wts, hst, lane, *xs, head=hw)
        counts = dict(kernels.launches), dict(kernels.variants)
        ref_h, ref_dx = stream.conv_gru_plain(wts, hst, lane, *xs, head=hw)
    torch.cuda.synchronize()
    assert counts == ({"conv_gru:gru08": 1}, {"conv_gru:gru08:lane8": 1})
    assert float((got_h.float() - ref_h.float()).abs().max()) <= 2.0 ** -5
    if not head_on:
        assert got_dx is None and ref_dx is None
        return
    dx_rms = float(ref_dx.square().mean().sqrt())
    assert float((got_dx - ref_dx).abs().max()) <= 2.0 ** -5 * dx_rms


@pytest.mark.gpu
@pytest.mark.parametrize("b,h16,w16,ch,cx0", GRU1632_TILING)
def test_gpu_gru1632_lane8_matches_serial_bitwise(cuda, b, h16, w16, ch, cx0):
    from raft_stereo_tpu_torch import kernels
    args = list(_gru1632_case(cuda, b, h16, w16, ch, 112, cx0=cx0))
    args[4], args[5] = quantize_feature8(args[4]), quantize_feature8(args[5])
    kernels.reset_launches()
    with torch.no_grad():
        got = stream.fused_gru1632(*args)
        serial = _gru1632_serial(*args)
        plain = stream.gru1632_plain(*args)
    torch.cuda.synchronize()
    assert kernels.variants == {"gru1632:lane8": 1, "conv_gru:gru16:lane8": 1,
                                "conv_gru:gru32:lane8": 1}
    with torch.no_grad():
        _assert_steps_within_band(*args)
    for g_, s_, p_ in zip(got, serial, plain):
        assert torch.equal(g_, s_)
        assert float((g_.float() - p_.float()).abs().max()) <= 2.0 ** -5
    mixed = list(args)
    mixed[5] = torch.zeros(args[5].q.shape, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):  # one level bf16, the other int8
        stream.fused_gru1632(*mixed)


@pytest.mark.gpu
@pytest.mark.parametrize("pack8", [False, True])
@pytest.mark.parametrize("b,h,w,ch", [(2, 7, 13, 32), (1, 96, 312, 128)])
def test_gpu_resident_lane8_matches_serial_bitwise(cuda, monkeypatch, b, h, w, ch, pack8):
    """The resident kernel's int8-czrq instantiations, on bf16 and on int8
    levels: bit for bit the serial lane8 chain, within the tolerance of the
    plain version, counted as fused_iter:lane8 or fused_iter:pack8+lane8;
    and a container with the switch off raises."""
    from raft_stereo_tpu_torch import kernels
    monkeypatch.setenv("RAFT_CORR_PACK8", "1" if pack8 else "0")
    monkeypatch.setenv("RAFT_LANE_PACK8", "1")
    args = list(_resident_case(cuda, b, h, w, ch, 113))
    assert args[3].pack8 == pack8
    args[5] = quantize_feature8(args[5])
    kernels.reset_launches()
    with torch.no_grad():
        got = resident.fused_iter(*args)
        serial = _resident_serial(*args)
        plain = resident.fused_iter_plain(*args)
    torch.cuda.synchronize()
    for g_, s_ in zip(got, serial):
        assert torch.equal(g_, s_)
    assert float((got[0].float() - plain[0].float()).abs().max()) <= 2.0 ** -5
    assert float((got[1] - plain[1]).abs().max()) <= 2.0 ** -5 * float(
        plain[1].square().mean().sqrt())
    mode = "pack8+lane8" if pack8 else "lane8"
    assert kernels.variants[f"fused_iter:{mode}"] == 1
    assert kernels.variants["conv_gru:gru08:lane8"] == 1
    monkeypatch.setenv("RAFT_LANE_PACK8", "0")
    with pytest.raises(RuntimeError, match="RAFT_LANE_PACK8"):
        resident.fused_iter(*args)


# -- the loop engine's patch tiling (csrc/loop_conv_sm90.cuh) ----------------------

# Maps under one 8 x 16 output patch and off its multiples, and B = 2.
TILING = [(1, 1, 1), (1, 2, 130), (1, 70, 3), (2, 9, 17)]
# gru08's hidden width and x2 parts after the motion features: none, one, and
# two with a 32-channel part (a chunk half filled, in the middle of the concat).
X2_PARTS = [(32, ()), (64, (64,)), (32, (32, 64))]


def _resident_parts_case(device, b, h, w, ch, x2, seed):
    """A resident case of any width: as many pyramid levels as the width
    holds (each level halves it; a level must keep a column), at most 4."""
    levels = min(4, w.bit_length())
    gru, head, _ = _modules_on(device, ch, 128 + sum(x2), seed)
    enc = BasicMotionEncoder(levels * 9)
    init_weights(enc, torch.Generator().manual_seed(seed + 2))
    enc = enc.to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(bf)

    with torch.no_grad():
        f1, f2 = rnd((b, h, w, 16)), rnd((b, h, w, 16))
        ops = reg_cuda.build_corr_operands(f1, f2, num_levels=levels, radius=4)
        coords = torch.rand((b, h, w), generator=g, device=device) * (w + 20) - 10
        flow = torch.cat([rnd((b, h, w, 1), 3.0), torch.zeros((b, h, w, 1), device=device,
                                                              dtype=bf)], -1)
        wts = (stream.motion_weights(enc, bf), stream.gru_weights(gru, bf, "gru08"),
               stream.head_weights(head, bf))
        czrq = stream.prepare_gru_context(gru, [rnd((b, h, w, ch), 0.3) for _ in range(3)], bf)
    return (*wts, ops, rnd((b, h, w, ch), 0.5), czrq, coords, flow,
            *(rnd((b, h, w, c)) for c in x2))


@pytest.mark.gpu
@pytest.mark.parametrize("pack8,lane8", [(False, False), (True, False), (False, True),
                                         (True, True)])
@pytest.mark.parametrize("ch,x2", X2_PARTS)
@pytest.mark.parametrize("b,h,w", TILING)
def test_gpu_resident_patch_tiling_matches_serial_bitwise(cuda, monkeypatch, b, h, w, ch, x2,
                                                          pack8, lane8):
    """All four resident instantiations on the loop engine's edge cases: bit
    for bit the serial chain (lookup, motion, gru08 + head, the same tile
    code in separate launches) and within the tolerance of the plain
    version; one launch, counted under its variant."""
    from raft_stereo_tpu_torch import kernels
    monkeypatch.setenv("RAFT_CORR_PACK8", "1" if pack8 else "0")
    monkeypatch.setenv("RAFT_LANE_PACK8", "1" if lane8 else "0")
    args = list(_resident_parts_case(cuda, b, h, w, ch, x2, 120 + b * h * w))
    assert args[3].pack8 == pack8
    if lane8:
        args[5] = quantize_feature8(args[5])
    kernels.reset_launches()
    with torch.no_grad():
        got = resident.fused_iter(*args)
        counts = dict(kernels.launches)
        serial = _resident_serial(*args)
        plain = resident.fused_iter_plain(*args)
    torch.cuda.synchronize()
    assert counts == {"fused_iter": 1}
    for g_, s_ in zip(got, serial):
        assert torch.equal(g_, s_)
    assert float((got[0].float() - plain[0].float()).abs().max()) <= 2.0 ** -5
    assert float((got[1] - plain[1]).abs().max()) <= 2.0 ** -5 * float(
        plain[1].square().mean().sqrt())


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w", TILING)
def test_gpu_motion_patch_tiling_integer_exact(cuda, b, h, w):
    """The motion kernel's two 3x3 stages on the loop engine's edge cases,
    integer weights and inputs: every sum exact, so equal to the plain
    version bit for bit."""
    _, _, enc = _modules_on(cuda, 32, 32, 130)
    g = torch.Generator(device=cuda).manual_seed(131)

    def ints(shape, lo=-1, hi=2):
        return torch.randint(lo, hi, shape, generator=g, device=cuda).float()

    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(ints(p.shape))
        wts = stream.motion_weights(enc, torch.bfloat16)
        corr = ints((b, h, w, 36), -3, 4).to(torch.bfloat16)
        flow = torch.cat([ints((b, h, w, 1), -3, 4), torch.zeros((b, h, w, 1), device=cuda)],
                         -1).to(torch.bfloat16)
        got = stream.fused_motion(wts, flow, corr)
        ref = stream.motion_plain(wts, flow, corr)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("ch,x2", X2_PARTS)
@pytest.mark.parametrize("b,h,w", TILING)
def test_gpu_conv_gru_head_patch_tiling_matches_plain(cuda, b, h, w, ch, x2):
    """gru08 + head on the loop engine's edge cases, x parts [motion, x2...]
    as in the loop: within the tolerance of the plain version."""
    gru, head, _ = _modules_on(cuda, ch, 128 + sum(x2), 140)
    g = torch.Generator(device=cuda).manual_seed(141)
    bf = torch.bfloat16
    hst = (torch.randn((b, h, w, ch), generator=g, device=cuda) * 0.5).to(bf)
    xs = [torch.randn((b, h, w, c), generator=g, device=cuda).to(bf) for c in (128, *x2)]
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


def _q8_close(lane: Lane8, ref: Lane8) -> bool:
    """Within two quantization steps of the plain version's container."""
    d = (lane.q.float() * lane.scale - ref.q.float() * ref.scale).abs().max()
    return float(d) <= 2.0 * float(torch.maximum(lane.scale, ref.scale))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,cin,cout", [(7, 13, 64, 64), (5, 131, 128, 384),
                                          (24, 78, 128, 384), (3, 259, 96, 160)])
def test_gpu_pass_q8_equals_host_quantization(cuda, h, w, cin, cout):
    from raft_stereo_tpu_torch import kernels
    g = torch.Generator(device=cuda).manual_seed(114)
    inputs = [_enc_triple(cuda, g, (1, h, w, cin), False)]
    wt, b = _enc_conv(cuda, cin, cout, 3, 115)
    kernels.reset_launches()
    lane, st = enc.conv_pass("raw1", inputs, wt, b, stats=False, quant=True)
    assert kernels.variants == {f"enc_pass:raw1/bn/{cin}/q8": 1}
    bf, _ = enc.conv_pass("raw1", inputs, wt, b, stats=False)
    again, _ = enc.conv_pass("raw1", inputs, wt, b, stats=False, quant=True)
    ref, _ = enc.conv_pass_plain("raw1", inputs, wt, b, stats=False, quant=True)
    host = quantize_feature8(bf)
    torch.cuda.synchronize()
    assert st is None and lane.q.dtype == torch.int8 and lane.q.shape == (1, h, w, cout)
    assert torch.equal(lane.q, host.q) and torch.equal(lane.scale, host.scale)
    assert torch.equal(lane.q, again.q) and torch.equal(lane.scale, again.scale)
    assert _q8_close(lane, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(29, 45), (1, 1)])
def test_gpu_pass_q8_over_several_patches(cuda, h, w):
    """The zqr width, 128 -> 384 (two column blocks of 192), on a map of
    several patches in both directions and on a single pixel: the conv runs
    once into a bf16 scratch map, so the container must be the host
    quantization of the bf16 pass's output bit for bit, two runs equal."""
    g = torch.Generator(device=cuda).manual_seed(123)
    inputs = [(torch.relu(_enc_triple(cuda, g, (1, h, w, 128), False)[0]), None, None)]
    wt, b = _enc_conv(cuda, 128, 384, 3, 124)
    lane, _ = enc.conv_pass("raw1", inputs, wt, b, stats=False, quant=True)
    again, _ = enc.conv_pass("raw1", inputs, wt, b, stats=False, quant=True)
    bf, _ = enc.conv_pass("raw1", inputs, wt, b, stats=False)
    ref, _ = enc.conv_pass_plain("raw1", inputs, wt, b, stats=False, quant=True)
    host = quantize_feature8(bf)
    torch.cuda.synchronize()
    assert torch.equal(lane.q, host.q) and torch.equal(lane.scale, host.scale)
    assert torch.equal(lane.q, again.q) and torch.equal(lane.scale, again.scale)
    assert _q8_close(lane, ref)


@pytest.mark.gpu
def test_gpu_pass_q8_rounds_half_to_even(cuda):
    """An identity conv passes the map through, and a map whose largest
    value is 127 has scale 1, so v / scale lands on half-integers: the
    kernel's quantization must round them to even, as the host's does."""
    ch = 64
    vals = torch.tensor([127.0, -127.0, 2.5, -2.5, 3.5, 0.5, -0.5, 1.5, 126.5, -126.5, 0.0, 7.0],
                        device=cuda)
    x = vals.repeat(9 * 11 * ch // len(vals) + 1)[:9 * 11 * ch].reshape(1, 9, 11, ch)
    wt = torch.zeros((ch, ch, 3, 3), device=cuda)
    wt[torch.arange(ch), torch.arange(ch), 1, 1] = 1.0
    inputs = [(x.to(torch.bfloat16), None, None)]
    lane, _ = enc.conv_pass("raw1", inputs, wt, None, stats=False, quant=True)
    host = quantize_feature8(inputs[0][0])
    torch.cuda.synchronize()
    assert float(lane.scale) == 1.0
    assert torch.equal(lane.q, host.q) and torch.equal(lane.scale, host.scale)
    assert int(lane.q.flatten()[2]) == 2 and int(lane.q.flatten()[4]) == 4


@pytest.mark.gpu
def test_gpu_pass_q8_integer_exact(cuda):
    """Integer inputs and weights: every sum is exact, so the container
    equals the plain version's bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(116)
    inputs = [_enc_triple(cuda, g, (1, 9, 37, 128), False, ints=True)]
    wt, b = _enc_conv(cuda, 128, 384, 3, 117, ints=True)
    lane, _ = enc.conv_pass("raw1", inputs, wt, b, stats=False, quant=True)
    ref, _ = enc.conv_pass_plain("raw1", inputs, wt, b, stats=False, quant=True)
    torch.cuda.synchronize()
    assert torch.equal(lane.q, ref.q) and torch.equal(lane.scale, ref.scale)


@pytest.mark.gpu
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("h,w,ch", [(7, 13, 64), (3, 259, 128), (2, 3, 8), (96, 312, 128)])
def test_gpu_point2_q8_equals_host_quantization(cuda, h, w, ch, norm):
    from raft_stereo_tpu_torch import kernels
    g = torch.Generator(device=cuda).manual_seed(118)
    shape = (1, h, w, ch)
    y = _enc_triple(cuda, g, shape, True)
    x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    kernels.reset_launches()
    lane = enc.point2(x, y, norm=norm, quant=True)
    assert kernels.variants == {f"enc_point2:{'instance' if norm else 'bn'}/{ch}/q8": 1}
    host = quantize_feature8(enc.point2(x, y, norm=norm))
    ref = enc.point2_plain(x, y, norm=norm, quant=True)
    torch.cuda.synchronize()
    assert torch.equal(lane.q, host.q) and torch.equal(lane.scale, host.scale)
    assert _q8_close(lane, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("h,w,ch", [(504, 744, 128), (2, 3, 8)])
def test_gpu_point2_q8_one_launch_twice(cuda, h, w, ch, norm):
    """point2 q8 in one launch: at 504x744x128 the exit is larger than the
    grid's shared memory, so most of it is recomputed after the barrier;
    two calls back to back (the scratch words zeroed by the first) give the
    same bits, which are the host quantization's."""
    g = torch.Generator(device=cuda).manual_seed(121)
    shape = (1, h, w, ch)
    y = _enc_triple(cuda, g, shape, True)
    x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    first = enc.point2(x, y, norm=norm, quant=True)
    second = enc.point2(x, y, norm=norm, quant=True)
    host = quantize_feature8(enc.point2(x, y, norm=norm))
    torch.cuda.synchronize()
    assert torch.equal(first.q, second.q) and torch.equal(first.scale, second.scale)
    assert torch.equal(first.q, host.q) and torch.equal(first.scale, host.scale)


@pytest.mark.gpu
def test_gpu_q8_exits_reject_what_they_do_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(119)
    inputs = [_enc_triple(cuda, g, (1, 8, 8, 64), True)]
    wt, b = _enc_conv(cuda, 64, 64, 3, 120)
    with pytest.raises(ValueError):  # only raw1 quantizes on exit
        enc.conv_pass("mid1", inputs, wt, b, stats=False, quant=True)
    with pytest.raises(ValueError):  # and never with statistics
        enc.conv_pass("raw1", [(inputs[0][0], None, None)], wt, b, stats=True, quant=True)


def _session_model(cuda):
    """The default full-width model, weights from seed 0, the flow head's
    last conv tempered as chip_smoke.py does (chip_smoke.seeded_model)."""
    import chip_smoke
    return chip_smoke.seeded_model(cuda.type)


@pytest.mark.gpu
def test_gpu_session_graph_replay_equals_eager(cuda):
    """The serving session's programs are CUDA graphs on the card: a request
    served by replaying the full program, and one served in deadline
    segments, equal the eager forward bit for bit; the full program
    captured the default path's kernels."""
    import numpy as np

    from raft_stereo_tpu_torch import kernels, raft_stereo_forward
    from raft_stereo_tpu_torch.serve import InferenceSession, SessionConfig
    model = _session_model(cuda)
    sess = InferenceSession(model, model.cfg, SessionConfig(valid_iters=4, segments=2),
                            device=cuda)
    rng = np.random.default_rng(3)
    left, right = (rng.uniform(0, 255, (1, 100, 230, 3)).astype(np.float32)
                   for _ in range(2))
    kernels.reset_launches()
    res = sess.infer(left, right)
    padder = sess.padder_for(left.shape)
    lp, rp = padder.pad_np(left, right)
    _, flow = raft_stereo_forward(model, torch.from_numpy(lp).to(cuda),
                                  torch.from_numpy(rp).to(cuda), iters=4)
    ref = -padder.unpad(flow)[0, ..., 0].cpu()
    assert res.quality == "full" and sess.status()["graphs"]
    assert torch.equal(torch.from_numpy(res.disparity), ref)
    again = sess.infer(left, right)  # a replay of the captured graph
    assert again.disparity.tobytes() == res.disparity.tobytes()
    seg = sess.infer(left, right, budget_s=600.0)
    assert seg.quality == "full" and seg.disparity.tobytes() == res.disparity.tobytes()
    captured = sess.program_launches("full", *padder.padded_shape, 4)
    assert captured["fused_iter"] == 4 and captured["gru1632"] == 4
    assert captured["enc_stem"] >= 1 and captured["enc_pass"] >= 1
    assert sess.breaker.trip_count == 0
    assert sess.breaker.kernels_only  # no rung on the card leaves the kernels


def _eager_disparity(model, sess, left, right, iters):
    """The eager forward on the card of a host pair, padded as ``sess``
    pads it: the disparity the session must serve."""
    from raft_stereo_tpu_torch import raft_stereo_forward
    padder = sess.padder_for(left.shape)
    lp, rp = padder.pad_np(left, right)
    _, flow = raft_stereo_forward(model, torch.from_numpy(lp).to(sess.device),
                                  torch.from_numpy(rp).to(sess.device), iters=iters)
    return (-padder.unpad(flow)[0, ..., 0].cpu()).numpy()


def _host_pairs(shapes, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32) for _ in range(2))
            for (h, w) in shapes]


@pytest.mark.gpu
def test_gpu_session_replays_beside_first_captures(cuda):
    """One thread serves a warm bucket again and again, in deadline
    segments (each segment's carry cloned on the card, allocating there)
    and whole, until two other threads have served two new buckets, whose
    programs are captured meanwhile, right after the capture empties the
    allocator's cache. A capture runs alone on the card, so every result
    equals the eager forward bit for bit and nothing fails."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from raft_stereo_tpu_torch.serve import InferenceSession, SessionConfig
    model = _session_model(cuda)
    sess = InferenceSession(model, model.cfg, SessionConfig(valid_iters=4, segments=2),
                            device=cuda)
    warm, new_a, new_b = _host_pairs(((100, 230), (60, 100), (130, 90)), seed=11)
    sess.infer(*warm)
    sess.infer(*warm, budget_s=600.0)
    refs = [_eager_disparity(model, sess, *p, 4) for p in (warm, new_a, new_b)]
    torch.cuda.synchronize(cuda)
    done = threading.Event()

    def replays():
        served = []
        while not done.is_set() or len(served) < 4:
            served.append(sess.infer(*warm, budget_s=600.0))
            served.append(sess.infer(*warm))
        return served

    with ThreadPoolExecutor(max_workers=3) as ex:
        again = ex.submit(replays)
        firsts = [ex.submit(sess.infer, *p) for p in (new_a, new_b)]
        try:
            got = [f.result(timeout=600) for f in firsts]
        finally:
            done.set()
        served = again.result(timeout=600)
    for res in served:
        assert res.quality == "full" and res.disparity.tobytes() == refs[0].tobytes()
    assert got[0].disparity.tobytes() == refs[1].tobytes()
    assert got[1].disparity.tobytes() == refs[2].tobytes()
    m = sess.metrics()
    assert m["compiles"] == 5 and m["requests_failed"] == 0  # full, prepare, segment + 2


@pytest.mark.gpu
def test_gpu_session_recaptures_after_eviction(cuda):
    """max_programs=1 with two shapes in turns: each request evicts the
    other bucket's graph and captures its own again, into a fresh pool;
    every result equals the eager forward bit for bit (no host cache keyed
    by pointer outlives the pool it points into)."""
    from raft_stereo_tpu_torch.serve import InferenceSession, SessionConfig
    model = _session_model(cuda)
    sess = InferenceSession(model, model.cfg,
                            SessionConfig(valid_iters=4, segments=2, max_programs=1),
                            device=cuda)
    pairs = _host_pairs(((100, 230), (60, 100)), seed=12)
    refs = [_eager_disparity(model, sess, *p, 4) for p in pairs]
    for i in range(4):
        res = sess.infer(*pairs[i % 2])
        assert res.disparity.tobytes() == refs[i % 2].tobytes(), i
    m = sess.metrics()
    assert m["compiles"] == 4 and m["evictions"] == 3 and m["requests_failed"] == 0


@pytest.mark.gpu
def test_gpu_kernels_write_nothing_past_their_outputs(cuda):
    """Every kernel of the model paths, on the default path (stem, pass,
    point3, point2, gru16+32, resident), the serial loop (lookup, the three
    GRU steps, motion) and alt_cuda (alt, gru16+32, motion, gru08+head),
    with every output and scratch map inside a larger buffer of sentinel
    bytes (chip_smoke.guarded_allocations): the margins stay as they
    were."""
    import chip_smoke
    model = _session_model(cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    pair = tuple(torch.rand((1, 100, 230, 3), generator=g, device=cuda) * 255
                 for _ in range(2))
    result = chip_smoke.check_overruns(model, pair)
    assert result["ok"] and set(result["routes"]) == {"default", "serial", "alt_cuda"}
    for name, route in result["routes"].items():
        assert route["ok"] and all(route["launches"].values()), name
    assert {k for r in result["routes"].values() for k in r["launches"]} >= {
        "corr_lookup", "conv_gru:gru08", "motion", "corr_alt", "fused_iter", "gru1632"}


def _padded_batch(sess, pairs):
    import numpy as np
    padder = sess.padder_for(pairs[0][0].shape)
    lp, rp = (np.ascontiguousarray(np.concatenate(x))
              for x in zip(*(padder.pad_np(*p) for p in pairs)))
    return padder, lp, rp


def _carry_bytes(state) -> list:
    from raft_stereo_tpu_torch.models.raft_stereo import _map_carry
    out = []
    _map_carry(lambda x: out.append(x.detach().cpu().contiguous().view(torch.uint8)), state)
    return out


def _same_carry(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_carry_bytes(a), _carry_bytes(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [2, 4])
def test_gpu_batched_programs_graph_equals_eager(cuda, b):
    """The scheduler's batched programs as CUDA graphs at 100x230: prepare
    and advance equal their eager runs bit for bit; the prepare runs row by
    row (each row the B=1 prepare's bits, the encoder kernels launched once
    a row) and the advance launches the loop kernels once an iteration;
    within the width a row does not depend on its batchmates (replicas of
    it as pad rows give its bits); against the B=1 programs each row's
    advance carry is bit for bit, and its upsampled flow holds to
    chip_smoke.CROSS_WIDTH_PIN (at this geometry the epilogue's fp32
    upsample einsum sums in another order at B=4)."""
    import numpy as np

    import chip_smoke
    from raft_stereo_tpu_torch.models import take_refinement_rows
    from raft_stereo_tpu_torch.serve import InferenceSession, SessionConfig
    from raft_stereo_tpu_torch.serve.guard import CANARY_ATOL, CANARY_RTOL
    from raft_stereo_tpu_torch.serve.session import build_program
    model = _session_model(cuda)
    sess = InferenceSession(model, model.cfg,
                            SessionConfig(valid_iters=4, segments=2, max_batch=4), device=cuda)
    pairs = _host_pairs([(100, 230)] * b, seed=13)
    padder, lp, rp = _padded_batch(sess, pairs)
    ph, pw = padder.padded_shape
    (state,) = sess.invoke(sess.get_program("prepare", ph, pw, 0, b=b), lp, rp)
    with torch.no_grad():
        (eager,) = build_program("prepare", model, 0)(torch.from_numpy(lp).to(cuda),
                                                      torch.from_numpy(rp).to(cuda))
    assert _same_carry(state, eager)
    solo = []
    for i in range(b):
        (s1,) = sess.invoke(sess.get_program("prepare", ph, pw, 0), lp[i:i + 1], rp[i:i + 1])
        assert _same_carry(take_refinement_rows(state, [i]), s1), i
        solo.append(s1)
    one = sess.program_launches("prepare", ph, pw, 0)
    assert one["enc_stem"] == 1 and one["enc_pass"] >= 1
    assert sess.program_launches("prepare", ph, pw, 0, b=b) == {k: b * n for k, n in one.items()}
    adv = sess.get_program("advance", ph, pw, 2, b=b)
    got, _, dnorm = sess.invoke(adv, state)
    with torch.no_grad():
        ref, _, ref_dnorm = build_program("advance", model, 2)(
            take_refinement_rows(eager, list(range(b))))
    assert _same_carry(got, ref) and torch.equal(torch.from_numpy(dnorm), ref_dnorm.cpu())
    assert sess.program_launches("advance", ph, pw, 2, b=b) == {"fused_iter": 2, "gru1632": 2}
    up, _ = sess.invoke(sess.get_program("epilogue", ph, pw, 0, b=b), got)
    adv1 = sess.get_program("advance", ph, pw, 2)
    epi1 = sess.get_program("epilogue", ph, pw, 0)
    for i in range(b):
        pad, _, _ = sess.invoke(adv, take_refinement_rows(state, [i] * b))
        assert _same_carry(take_refinement_rows(pad, [0]), take_refinement_rows(got, [i])), i
        s1, _, _ = sess.invoke(adv1, solo[i])
        assert _same_carry(take_refinement_rows(got, [i]), s1), i
        up1, _ = sess.invoke(epi1, s1)
        if chip_smoke.CROSS_WIDTH_PIN == "bitwise":
            assert up1.tobytes() == up[i:i + 1].tobytes(), i
        else:
            assert np.allclose(up[i:i + 1], up1, rtol=CANARY_RTOL, atol=CANARY_ATOL), (
                i, float(np.abs(up[i:i + 1] - up1).max()))
    assert sess.breaker.trip_count == 0


@pytest.mark.gpu
def test_gpu_scheduler_uploads_beside_first_captures(cuda):
    """One scheduler's first ticks capture its batched programs while a
    second scheduler's uploader copies pairs to the card on its own stream
    the whole time: the captures hold (the uploads wait on the session's
    device_ops gate), every served row equals the eager b=4 run bit for
    bit, and every upload equals its host pair."""
    import threading
    import time

    import numpy as np

    from raft_stereo_tpu_torch.serve import BatchScheduler, InferenceSession, SessionConfig
    from raft_stereo_tpu_torch.serve.session import build_program
    from raft_stereo_tpu_torch.serve.validate import AdmissionConfig, validate_pair
    model = _session_model(cuda)
    scfg = SessionConfig(valid_iters=4, segments=2, max_batch=4)
    sess_a = InferenceSession(model, model.cfg, scfg, device=cuda)
    sess_b = InferenceSession(model, model.cfg, scfg, device=cuda)
    pairs_a = _host_pairs([(100, 230)] * 4, seed=14)
    pairs_b = _host_pairs([(60, 100)] * 6, seed=15)
    out = []
    sched_a = BatchScheduler(sess_a, resolve=lambda req, resp: out.append(resp))
    sched_b = BatchScheduler(sess_b, resolve=lambda req, resp: None)

    def request(i, p):
        left, right = validate_pair(p[0], p[1], AdmissionConfig())
        return {"id": i, "left": left, "right": right, "_deadline": None}

    for i, p in enumerate(pairs_a):
        sched_a.submit(request(i, p))
    for bucket in sched_a._buckets.values():
        for row in list(bucket.pending):
            assert row.uploaded.wait(timeout=60)
    done = threading.Event()
    submitted = []

    def upload_storm():
        k = 0
        while not done.is_set():
            sched_b.submit(request(k, pairs_b[k % len(pairs_b)]))
            submitted.append(k)
            k += 1
            time.sleep(0.001)

    storm = threading.Thread(target=upload_storm)
    storm.start()
    try:
        spins = 0
        while len(out) < 4:
            if not sched_a.run_tick():
                time.sleep(0.002)
            spins += 1
            assert spins < 2000
    finally:
        done.set()
        storm.join(timeout=60)
    assert submitted and sess_a.metrics()["compiles"] == 3  # prepare, advance, epilogue
    padder, lp, rp = _padded_batch(sess_a, pairs_a)
    with torch.no_grad():
        (state,) = build_program("prepare", model, 0)(torch.from_numpy(lp).to(cuda),
                                                      torch.from_numpy(rp).to(cuda))
        _, flow, _ = build_program("segment", model, 4)(state)
    for r in out:
        ref = (-padder.unpad(flow[r["id"]:r["id"] + 1])[0, ..., 0]).cpu().numpy()
        assert r["status"] == "ok" and r["disparity"].tobytes() == ref.tobytes(), r["id"]
    pad_b = sess_b.padder_for(pairs_b[0][0].shape)
    rows = [row for bucket in sched_b._buckets.values() for row in bucket.pending]
    assert len(rows) == len(submitted)
    for row in rows:
        assert row.uploaded.wait(timeout=60) and row.upload_error is None
        row.dev_event.synchronize()
        host = pad_b.pad_np(row.request["left"], row.request["right"])
        for dev, h in zip(row.dev_pair, host):
            assert np.array_equal(dev.cpu().numpy(), h)
    sched_b.shutdown()
    sched_a.shutdown()


@pytest.mark.gpu
def test_gpu_prepare_warm_graph_equals_eager(cuda):
    """The prepare_warm program as a CUDA graph at 100x230: its carry is the
    eager prepare_warm's bit for bit, a replay with another seed is too,
    and it captured the cold prepare's encoder launches (the seed only
    moves coords1)."""
    import numpy as np

    from raft_stereo_tpu_torch.serve import InferenceSession, SessionConfig
    from raft_stereo_tpu_torch.serve.session import build_program
    model = _session_model(cuda)
    sess = InferenceSession(model, model.cfg, SessionConfig(valid_iters=4, segments=2),
                            device=cuda)
    padder, lp, rp = _padded_batch(sess, _host_pairs([(100, 230)], seed=16))
    ph, pw = padder.padded_shape
    f = model.cfg.downsample_factor
    rng = np.random.default_rng(17)
    cold = sess.invoke(sess.get_program("prepare", ph, pw, 0), lp, rp)
    warm = sess.get_program("prepare_warm", ph, pw, 0)
    for _ in range(2):
        seed = rng.uniform(-3, 3, (1, ph // f, pw // f, 1)).astype(np.float32)
        (state,) = sess.invoke(warm, lp, rp, seed)
        with torch.no_grad():
            (eager,) = build_program("prepare_warm", model, 0)(
                torch.from_numpy(lp).to(cuda), torch.from_numpy(rp).to(cuda),
                torch.from_numpy(seed).to(cuda))
        assert _same_carry(state, eager)
    assert sess.program_launches("prepare_warm", ph, pw, 0) == \
        sess.program_launches("prepare", ph, pw, 0)
    assert cold is not None and sess.breaker.trip_count == 0


@pytest.mark.gpu
def test_gpu_warm_row_same_bits_in_two_batch_compositions(cuda):
    """A warm row (a seeded prepare_warm join) at batch bucket 4 beside two
    and beside three cold rows: its disparity has the same bits in both
    batches, and differs from the cold rows' (it did warm-start)."""
    import time

    import numpy as np

    from raft_stereo_tpu_torch.serve import BatchScheduler, InferenceSession, SessionConfig
    from raft_stereo_tpu_torch.serve.validate import AdmissionConfig, validate_pair
    model = _session_model(cuda)
    sess = InferenceSession(model, model.cfg,
                            SessionConfig(valid_iters=4, segments=2, max_batch=4), device=cuda)
    (pair,) = _host_pairs([(100, 230)], seed=18)
    left, right = validate_pair(pair[0], pair[1], AdmissionConfig())
    ph, pw = sess.padder_for(left.shape).padded_shape
    f = model.cfg.downsample_factor
    seed = np.random.default_rng(19).uniform(-2, 2, (1, ph // f, pw // f, 1)).astype(
        np.float32)

    def run(n_cold):
        out = {}
        sched = BatchScheduler(sess, resolve=lambda rq, rs: out.__setitem__(rq["id"], rs))
        sched.submit({"id": "w", "left": left, "right": right, "_flow_init": seed.copy()})
        for i in range(n_cold):
            sched.submit({"id": f"c{i}", "left": left, "right": right})
        for bucket in sched._buckets.values():
            for row in list(bucket.pending):
                assert row.uploaded.wait(timeout=60)
        spins = 0
        while len(out) < n_cold + 1:
            if not sched.run_tick():
                time.sleep(0.002)
            spins += 1
            assert spins < 2000
        sched.shutdown()
        return out

    a, b = run(2), run(3)
    assert a["w"]["status"] == b["w"]["status"] == "ok"
    assert a["w"]["disparity"].tobytes() == b["w"]["disparity"].tobytes()
    assert a["w"]["disparity"].tobytes() != a["c0"]["disparity"].tobytes()
    # The warm row's prepare_warm ran at b=1, the two cold rows' prepare at
    # b=2: the same encoder launches a row.
    warm1 = sess.program_launches("prepare_warm", ph, pw, 0)
    assert warm1 and {k: 2 * n for k, n in warm1.items()} == \
        sess.program_launches("prepare", ph, pw, 0, b=2)
    assert sess.breaker.trip_count == 0


@pytest.mark.gpu
def test_gpu_exact_cache_hit_counts_no_program_call(cuda):
    """An exact repeat on the card comes back cache:exact, bit for bit the
    computed response, with no program call and no kernel launch."""
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.serve import (InferenceSession, ServiceConfig, SessionConfig,
                                             StereoService)
    model = _session_model(cuda)
    sess = InferenceSession(model, model.cfg, SessionConfig(valid_iters=4, segments=2),
                            device=cuda)
    svc = StereoService(sess, ServiceConfig(cache_bytes=64 << 20))
    (pair,) = _host_pairs([(100, 230)], seed=20)
    cold = svc.handle({"id": "cold", "left": pair[0], "right": pair[1]})
    calls = sum(v for _, v in sess.registry.series("raft_program_calls_total"))
    device = sum(v for _, v in sess.registry.series("raft_program_device_seconds_total"))
    launches = dict(kernels.launches)
    hit = svc.handle({"id": "hit", "left": pair[0], "right": pair[1]})
    assert cold["quality"] == "full" and hit["quality"] == "cache:exact"
    assert hit["disparity"].tobytes() == cold["disparity"].tobytes()
    assert sum(v for _, v in sess.registry.series("raft_program_calls_total")) == calls
    assert sum(v for _, v in sess.registry.series(
        "raft_program_device_seconds_total")) == device
    assert dict(kernels.launches) == launches


# -- training: the kernels' backward on the card ------------------------------------
# Each differentiable kernel entry (ops/grad.py) runs its kernel forward on
# the card and autograd through its plain version backward, on the card;
# the CPU copy runs the plain version both ways. Gradients in bf16 are held
# per tensor to a relative L2 of 2^-4 (the forward differs by bf16 ulps, and
# the card's convolutions sum the backward in another order), the
# denominator floored at 1e-2 of the case's largest gradient norm: a conv
# bias before instance norm has a true gradient of zero and holds bf16
# noise on both sides (the first card run read 1.14 for it unfloored).
GRAD_REL = 2.0 ** -4


def _bwd_rel(a, b, floor: float = 1e-12) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / max(float(b.norm()), floor))


def _bwd_both(make, seed):
    """``make(device, generator)`` -> (output, leaves) on the card and on the
    CPU from the same seed; returns the gradients of a fixed projection."""
    out = {}
    for dev in ("cuda", "cpu"):
        o, leaves = make(torch.device(dev), torch.Generator().manual_seed(seed))
        outs = [t for t in (o if isinstance(o, (tuple, list)) else (o,)) if t is not None]
        g = torch.Generator().manual_seed(seed + 100)
        total = sum((t.float() * torch.randn(t.shape, generator=g).to(t.device)).sum()
                    for t in outs)
        out[dev] = torch.autograd.grad(total, leaves, allow_unused=True)
        assert all(t.grad_fn is not None for t in outs)
    return out["cuda"], out["cpu"]


def _bwd_leaf(shape, g, dev, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g) * scale).to(device=dev, dtype=dtype).requires_grad_()


def _bwd_gru(dev, g, head):
    gru, fh, _ = _modules_on(dev, 64, 64, 3)
    h = _bwd_leaf((2, 12, 20, 64), g, dev)
    ctx = [_bwd_leaf((2, 12, 20, 64), g, dev) for _ in range(3)]
    x = _bwd_leaf((2, 12, 20, 64), g, dev)
    czrq = stream.prepare_gru_context(gru, ctx, torch.bfloat16)
    w = stream.gru_weights(gru, torch.bfloat16, "gru08")
    hd = stream.head_weights(fh, torch.bfloat16) if head else None
    out = stream.fused_conv_gru(w, h, czrq, x, head=hd)
    leaves = [h, *ctx, x, *gru.parameters()] + (list(fh.parameters()) if head else [])
    return (out if head else out[0]), leaves


def _bwd_motion(dev, g):
    _, _, m = _modules_on(dev, 64, 64, 5)
    corr = _bwd_leaf((2, 12, 20, 36), g, dev)
    flow = torch.cat([_bwd_leaf((2, 12, 20, 1), g, dev, 4.0).detach(),
                      torch.zeros(2, 12, 20, 1, dtype=torch.bfloat16, device=dev)], -1)
    flow.requires_grad_()
    return stream.fused_motion(stream.motion_weights(m, torch.bfloat16), flow, corr), \
        [flow, corr, *m.parameters()]


def _bwd_gru1632(dev, g):
    g16, _, _ = _modules_on(dev, 64, 128, 7)
    g32, _, _ = _modules_on(dev, 64, 64, 8)
    h16, h32 = _bwd_leaf((2, 16, 24, 64), g, dev), _bwd_leaf((2, 8, 12, 64), g, dev)
    c16 = [_bwd_leaf((2, 16, 24, 64), g, dev) for _ in range(3)]
    c32 = [_bwd_leaf((2, 8, 12, 64), g, dev) for _ in range(3)]
    x0p, x1p = _bwd_leaf((2, 16, 24, 64), g, dev), _bwd_leaf((2, 8, 12, 64), g, dev)
    out = stream.fused_gru1632(
        stream.gru_weights(g16, torch.bfloat16, "gru16"),
        stream.gru_weights(g32, torch.bfloat16, "gru32"), h16, h32,
        stream.prepare_gru_context(g16, c16, torch.bfloat16),
        stream.prepare_gru_context(g32, c32, torch.bfloat16), x0p, x1p)
    return out, [h16, h32, x0p, x1p, *c16, *c32, *g16.parameters(), *g32.parameters()]


def _bwd_lookup(dev, g, alt=False):
    f1 = _bwd_leaf((2, 6, 40, 64), g, dev)
    f2 = _bwd_leaf((2, 6, 40, 64), g, dev)
    coords = (torch.rand((2, 6, 40), generator=g) * 48 - 4).to(dev)
    if alt:
        fn = alt_cuda.make_alt_cuda_corr_fn(f1, f2, num_levels=4, radius=4)
    else:
        fn = reg_cuda.corr_fn_from_operands(
            reg_cuda.build_corr_operands(f1, f2, num_levels=4, radius=4))
    return fn(coords), [f1, f2]


def _bwd_encoder(dev, g, chain):
    from raft_stereo_tpu_torch.models.extractor import MultiBasicEncoder
    model = MultiBasicEncoder(output_dim=[(128, 128, 128)] * 2, norm_fn="batch", downsample=2)
    init_weights(model, torch.Generator().manual_seed(9))
    model = model.to(dev)
    if chain in ("stem_layer1", "in_stem_layer1"):
        x = _bwd_leaf((1, 40, 72, 3), g, dev)
        fn = enc.fused_stem_layer1 if chain == "stem_layer1" else enc.fused_in_stem_layer1
        return fn(model, x), [x, *model.conv1.parameters(), *model.layer1.parameters()]
    if chain == "resblock":
        x = _bwd_leaf((1, 20, 36, 96), g, dev)
        blk = model.layer2[1]
        return enc.stream_resblock(blk, x, "batch"), [x, *blk.parameters()]
    conv = model.outputs08[0][1]
    x = _bwd_leaf((1, 20, 36, 128), g, dev)
    return enc.stream_head_conv(conv, x), [x, *conv.parameters()]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["gru", "gru_head", "motion", "gru1632", "lookup", "alt",
                                  "stem_layer1", "in_stem_layer1", "resblock", "head_conv"])
def test_gpu_kernel_backward_matches_cpu_plain(cuda, case):
    from raft_stereo_tpu_torch import kernels
    makers = {"gru": lambda d, g: _bwd_gru(d, g, False),
              "gru_head": lambda d, g: _bwd_gru(d, g, True),
              "motion": _bwd_motion, "gru1632": _bwd_gru1632,
              "lookup": _bwd_lookup, "alt": lambda d, g: _bwd_lookup(d, g, True)}
    make = makers.get(case, lambda d, g: _bwd_encoder(d, g, case))
    kernels.reset_launches()
    card, cpu = _bwd_both(make, 21)
    assert sum(kernels.launches.values()) > 0, "no kernel launched on the card"
    floor = 1e-2 * max(float(b.float().norm()) for b in cpu if b is not None)
    for i, (a, b) in enumerate(zip(card, cpu)):
        if b is None:
            assert a is None or not float(a.abs().max()) > 0, (case, i)
            continue
        assert _bwd_rel(a, b, floor) <= GRAD_REL, (case, i, _bwd_rel(a, b, floor))


@pytest.mark.gpu
def test_gpu_module_weights_in_grad_mode_train_the_encoder_convs(cuda):
    """In grad mode the encoder chains take freshly folded, differentiable
    weights: the context net's stem and layer1 convs and BatchNorm
    parameters get gradients through the kernels' chain on the card."""
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.models.extractor import MultiBasicEncoder
    model = MultiBasicEncoder(output_dim=[(128, 128, 128)] * 2, norm_fn="batch", downsample=2)
    init_weights(model, torch.Generator().manual_seed(4))
    model = model.to(cuda)
    x = torch.rand((1, 64, 96, 3), device=cuda, dtype=torch.bfloat16)
    kernels.reset_launches()
    out = model(x)
    (sum(o.float().square().mean() for lvl in out for o in lvl)).backward()
    assert kernels.launches["enc_stem"] == 1 and kernels.launches["enc_pass"] == 14
    for m in (model.conv1, model.norm1, model.layer1[0].conv1, model.layer1[1].norm2):
        assert all(p.grad is not None and float(p.grad.abs().max()) > 0
                   for p in m.parameters())


@pytest.mark.gpu
def test_gpu_kernels_read_nothing_past_their_inputs(cuda):
    """Every kernel of the model paths (the default path, the serial loop,
    alt_cuda), one KITTI frame a route in a child process, with every
    kernel input's end (plus the kernel's declared slack: the lookup's
    16-byte unit) on a page that is never mapped
    (chip_smoke.check_overreads): no route faults, and every route
    launches its kernels."""
    import chip_smoke
    result = chip_smoke.check_overreads()
    assert result["ok"] and set(result["routes"]) == {"default", "serial", "alt_cuda"}
    for name, route in result["routes"].items():
        assert route["exit"] == 0 and route["placed"] > 0, (name, route)
        assert all(route["launches"].values()), (name, route)


@pytest.mark.gpu
def test_gpu_headline_ladder_programs_differ_in_their_launches(cuda):
    """The breaker ladder's nine headline programs (untripped from the
    armed base, then each rung on top of the ones before), recorded on the
    card: pairwise different in their kernel launches (by kernel and
    variant: the int8 rungs change variants), so each rung changes what the
    card runs. The program above the bottom still launches the serial
    loop's ConvGRU and motion kernels; the fully tripped one (fused_update
    too) launches no hand-written kernel, as the JAX package's last ladder
    program runs none."""
    from raft_stereo_tpu_torch.analysis.trace import TraceContext, default_registry
    registry = default_registry("headline")
    ctx = TraceContext(registry)
    launches = []
    for label, entry in registry.ladder_variants:
        rec = ctx.recording(entry)
        assert rec is not None, (label, ctx.trace_errors())
        launches.append(tuple(sorted(rec.launches(variants=True).items())))
    assert len(launches) == 9
    assert len(set(launches)) == 9, launches
    serial = dict(launches[-2])
    assert serial.get("motion") and serial.get("conv_gru:gru08"), serial
    assert not any(k.startswith(("fused_iter", "gru1632", "corr_", "enc_")) for k in serial)
    assert launches[-1] == (), launches[-1]


@pytest.mark.gpu
def test_gpu_lock_witness_explains_every_lock_edge(cuda):
    """chip_smoke.py phase 14: the card's serving stack (CUDA-graph
    programs, the scheduler, streams, the cache, the HTTP frontend, a
    build failure that trips fuse_iter, a hang the supervisor bounces)
    driven in a child process under graftlock's runtime witness: no
    observed lock edge outside the port's static graph, at least
    WITNESS_MIN_MAPPED mapped, every module-level lock seen, and the first
    response bit for bit the same request served without the witness."""
    import chip_smoke
    line = chip_smoke.phase_lock_witness("test")
    assert line["unexplained"] == []
    assert line["edges_mapped"] >= chip_smoke.WITNESS_MIN_MAPPED
    assert line["first_bitwise_without_witness"]
    assert all(line["module_locks_seen"].values())
    assert line["trips"] == ["fuse_iter"] and line["bounced"] == ["device_hang"]
