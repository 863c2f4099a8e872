#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raft_stereo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from raft_stereo_tpu_torch/csrc with nvcc
   (sm_90a), one nvcc per source, all at once;
3. each kernel against its plain torch version on the card, at the shapes
   the main path gives it (KITTI 375x1242 padded to 384x1248: features at
   96x312, B=1, bf16): max |error| against a stated tolerance; device ms per
   call of the kernel and of the plain version (torch.profiler, ``ms`` and
   ``plain_ms``), and the same calls' wall ms with the Python wrapper
   around them (CUDA events, ``wrapper_ms`` and ``plain_wall_ms``); and the
   analytic bound. The gru16+32 and resident kernels must also equal, bit
   for bit, the serial CUDA chain they replace (``serial_ms``: its device
   ms);
4. the main path at full width: the default model (hidden 128x3, 3 GRU
   levels, 4 corr levels, radius 4, bf16, reg_cuda) with weights from a
   seed, through the demo's inference function at 32 iterations, with the
   launch counts set to 0 before each path and read after it:
   - the default loop, three random 375x1242 pairs: 32 fused_iter and 32
     gru1632 launches a frame and none of the serial kernels;
   - the serial loop (RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0) on the first
     pair again: 32 lookup, 32 motion and 32 GRU launches at each of the
     three levels, and a disparity equal bit for bit to the default loop's;
   - one random Middlebury-F pair (2016x2976, the JAX package's headline
     geometry) through the default loop;
   per-frame ms and peak memory for each;
5. the same seeded model at 128x256 and 8 iterations on the card and on the
   CPU (plain versions), disparities held to a stated band.

The seeded model's flow-head output conv is scaled by 1/50 (``seeded_model``): at
random init it moves the coordinates ~35 px an iteration, which sends the
lookups off the pyramid rows and makes the loop chaotic, so bf16 rounding
differences grow into pixels (the JAX package's own bf16 kernel and XLA
paths then differ that much too). Scaled, an iteration moves under a pixel
or so, as a trained model's does.

The line before the last is {"kernels": [...]}, each kernel's launches
counted on the path that runs it (named in ``path``); the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this file, it exits non-zero and prints neither.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

KITTI = (375, 1242)
FEAT = (96, 312)  # 1/4 of the padded 384x1248
MIDDLEBURY_F = (2016, 2976)
ITERS = 32
N_FRAMES = 3
SWITCHES = ("RAFT_FUSE_ITER", "RAFT_FUSE_GRU1632")


def _wall_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn``, CUDA events around the
    Python call: the wrapper's checks and allocations are inside, so for a
    short kernel this is host time, not the kernel's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds of one call of ``fn``: the summed durations of
    the kernels, copies and fills it puts on the card (torch.profiler) over
    ``reps`` calls, divided by ``reps``. Host time between them is left out."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us <= 0:
        raise SystemExit("the profiler recorded no device time")
    return total_us / 1e3 / reps


def _timings(kernel, plain) -> dict:
    return {"ms": _device_ms(kernel), "wrapper_ms": _wall_ms(kernel),
            "plain_ms": _device_ms(plain), "plain_wall_ms": _wall_ms(plain)}


def _max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def _bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return {"nvidia_smi": smi}


def phase_build() -> float:
    from raft_stereo_tpu_torch import kernels
    seconds = kernels.build()
    print(json.dumps({"phase": "build", "seconds": seconds,
                      "sources": list(kernels.SOURCES)}))
    return seconds


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def _randn(shape, gen, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def check_lookup() -> dict:
    """Kernel 1 at the main path's shapes: bf16 pyramid of a 96x312 frame,
    coords spread past both ends of the row. Tolerance 0: the kernel and the
    plain version do the same fp32 operations in the same order."""
    from raft_stereo_tpu_torch.corr import reg_cuda
    g = _gen(1)
    h, w = FEAT
    f1 = _randn((1, h, w, 256), g)
    f2 = _randn((1, h, w, 256), g)
    ops = reg_cuda.build_corr_operands(f1, f2, num_levels=4, radius=4)
    coords = torch.rand((1, h, w), generator=g, device="cuda") * (w + 40) - 20
    got = reg_cuda.lookup(ops, coords)
    ref = reg_cuda.lookup_plain(ops, coords)
    torch.cuda.synchronize()
    err = _max_err(got, ref)
    npix = h * w
    k = 9
    nbytes = npix * (4 + 4 * (k + 1) * 2 + 4 * k * 2)
    flops = npix * 4 * k * 3
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_FP32)
    return {"name": "corr_lookup", "counter": "corr_lookup", "tol": 0.0, "max_abs_err": err,
            **_timings(lambda: reg_cuda.lookup(ops, coords),
                       lambda: reg_cuda.lookup_plain(ops, coords)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": f"1x{h}x{w}, 4 levels, r=4, bf16"}


def _gru_case(g, level, h, w, ch, parts, head: bool):
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import ConvGRU, FlowHead
    from raft_stereo_tpu_torch.ops import stream
    gru = ConvGRU(ch, sum(parts))
    fh = FlowHead(ch, 256, 2)
    init_weights(gru, torch.Generator().manual_seed(2))
    init_weights(fh, torch.Generator().manual_seed(3))
    gru, fh = gru.cuda(), fh.cuda()
    hst = _randn((1, h, w, ch), g, 0.5)
    xs = [_randn((1, h, w, c), g) for c in parts]
    ctx = [_randn((1, h, w, ch), g, 0.3) for _ in range(3)]
    with torch.no_grad():
        wts = stream.gru_weights(gru, torch.bfloat16, level)
        hw = stream.head_weights(fh, torch.bfloat16) if head else None
        czrq = stream.prepare_gru_context(gru, ctx, torch.bfloat16)
    return wts, hw, hst, czrq, xs


def check_gru(level: str) -> dict:
    """Kernel 2 at one GRU level's main-path shapes. Tolerance: the kernel
    sums in another order than cuDNN's fp32 conv, so a bf16 rounding of
    z, r, q (or f1) can land one ulp apart and carry into h' (and dx):
    |err| <= 2^-5 (8 bf16 ulps at 1.0) for h' in [-1, 1], and 2^-5 of the
    RMS of dx for dx. A wrong tap, halo or border moves dx by about its RMS,
    32x that bound; the measured error sits several times under it (PERF.md)."""
    from raft_stereo_tpu_torch.ops import stream
    g = _gen(4)
    ch = 128
    h, w = {"gru08": FEAT, "gru16": (FEAT[0] // 2, FEAT[1] // 2),
            "gru32": (FEAT[0] // 4, FEAT[1] // 4)}[level]
    parts = {"gru08": (128, 128), "gru16": (128, 128), "gru32": (128,)}[level]
    head = level == "gru08"
    wts, hw, hst, czrq, xs = _gru_case(g, level, h, w, ch, parts, head)
    with torch.no_grad():
        got_h, got_dx = stream.fused_conv_gru(wts, hst, czrq, *xs, head=hw)
        ref_h, ref_dx = stream.conv_gru_plain(wts, hst, czrq, *xs, head=hw)
    torch.cuda.synchronize()
    tol = 2.0 ** -5
    err = _max_err(got_h, ref_h)
    detail = {"max_abs_err_h": err}
    ok = err <= tol
    if head:
        dx_rms = float(ref_dx.square().mean().sqrt())
        dx_err = _max_err(got_dx, ref_dx)
        detail.update(max_abs_err_dx=dx_err, tol_dx=tol * dx_rms, dx_rms=dx_rms)
        ok = ok and dx_err <= tol * dx_rms
        err = max(err, dx_err)
    npix = h * w
    cx = sum(parts)
    macs = _gru_macs(ch, cx)
    wbytes = 9 * (ch + cx) * 3 * ch * 2 + 9 * ch * ch * 2
    nbytes = npix * 2 * (ch + 3 * ch + cx + ch)
    if head:
        macs += 9 * (ch * 256 + 256)
        wbytes += 9 * ch * 256 * 2 + 9 * 256 * 2
        nbytes += npix * 4
    bound_ms, bound_by = _bound(nbytes + wbytes, 2.0 * macs * npix, PEAK_BF16)

    def kernel():
        with torch.no_grad():
            stream.fused_conv_gru(wts, hst, czrq, *xs, head=hw)

    def plain():
        with torch.no_grad():
            stream.conv_gru_plain(wts, hst, czrq, *xs, head=hw)

    return {"name": f"conv_gru:{level}{'+head' if head else ''}",
            "counter": f"conv_gru:{level}", "tol": tol, "ok": ok, "max_abs_err": err,
            **detail, **_timings(kernel, plain), "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": f"1x{h}x{w}x{ch}, x parts {list(parts)}, bf16"}


def check_motion() -> dict:
    """Kernel 3 at the main path's shapes. Tolerance as for the GRU: a
    bf16 rounding one ulp apart in c1/f1/c2/f2 carries into the fused
    channels, |err| <= 2^-5 of max(1, max|fused|), the scale taken over the
    fused channels only. The two flow channels the kernel copies must equal
    the flow bit for bit."""
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import BasicMotionEncoder
    from raft_stereo_tpu_torch.ops import stream
    g = _gen(5)
    h, w = FEAT
    enc = BasicMotionEncoder(36)
    init_weights(enc, torch.Generator().manual_seed(6))
    enc = enc.cuda()
    corr = _randn((1, h, w, 36), g)
    flow = torch.cat([_randn((1, h, w, 1), g, 4.0),
                      torch.zeros((1, h, w, 1), device="cuda", dtype=torch.bfloat16)], -1)
    with torch.no_grad():
        wts = stream.motion_weights(enc, torch.bfloat16)
        got = stream.fused_motion(wts, flow, corr)
        ref = stream.motion_plain(wts, flow, corr)
    torch.cuda.synchronize()
    cf = wts.cf
    scale = max(1.0, float(ref[..., :cf].float().abs().max()))
    err = _max_err(got, ref)
    tol = 2.0 ** -5 * scale
    flow_exact = torch.equal(got[..., cf:], flow)
    npix = h * w
    macs = 36 * 64 + 49 * 64 + 2 * 9 * 64 * 64 + 9 * 128 * 126
    nbytes = npix * (36 * 2 + 2 * 2 + 128 * 2) + 2 * (36 * 64 + 49 * 64 + 9 * 128 * 254)
    bound_ms, bound_by = _bound(nbytes, 2.0 * macs * npix, PEAK_BF16)
    return {"name": "motion", "counter": "motion", "tol": tol,
            "ok": err <= tol and flow_exact, "max_abs_err": err,
            "flow_channels_exact": flow_exact,
            **_timings(lambda: stream.fused_motion(wts, flow, corr),
                       lambda: stream.motion_plain(wts, flow, corr)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": f"1x{h}x{w}, corr 36, bf16"}


def _serial_gru1632(w16, w32, h16, h32, czrq16, czrq32, x0p, x1p):
    """The serial CUDA route the gru16+32 kernel replaces."""
    from raft_stereo_tpu_torch.ops import stream
    from raft_stereo_tpu_torch.ops.resize import interp_align_corners
    h32n, _ = stream.fused_conv_gru(w32, h32, czrq32, x1p)
    h16n, _ = stream.fused_conv_gru(w16, h16, czrq16, x0p,
                                    interp_align_corners(h32n, tuple(h16.shape[1:3])))
    return h16n, h32n


def _gru_macs(ch: int, cx: int) -> int:
    """MACs a pixel of one ConvGRU step: gates over [h; x], q over r*h."""
    return 9 * (cx * 3 * ch + ch * 2 * ch + ch * ch)


def check_gru1632() -> dict:
    """Kernel 4 at the main path's shapes (gru16 48x156, gru32 24x78, 128
    channels). Tolerance as for the GRU kernel, 2^-5 on both states; and
    bit for bit the serial CUDA chain (two GRU launches and the resize)."""
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import ConvGRU
    from raft_stereo_tpu_torch.ops import stream
    g = _gen(11)
    ch, bf = 128, torch.bfloat16
    (h16, w16), (h32, w32) = (FEAT[0] // 2, FEAT[1] // 2), (FEAT[0] // 4, FEAT[1] // 4)
    g16, g32 = ConvGRU(ch, 2 * ch), ConvGRU(ch, ch)
    init_weights(g16, torch.Generator().manual_seed(12))
    init_weights(g32, torch.Generator().manual_seed(13))
    g16, g32 = g16.cuda(), g32.cuda()
    with torch.no_grad():
        args = (stream.gru_weights(g16, bf, "gru16"), stream.gru_weights(g32, bf, "gru32"),
                _randn((1, h16, w16, ch), g, 0.5), _randn((1, h32, w32, ch), g, 0.5),
                stream.prepare_gru_context(g16, [_randn((1, h16, w16, ch), g, 0.3)
                                                 for _ in range(3)], bf),
                stream.prepare_gru_context(g32, [_randn((1, h32, w32, ch), g, 0.3)
                                                 for _ in range(3)], bf),
                _randn((1, h16, w16, ch), g), _randn((1, h32, w32, ch), g))
        got = stream.fused_gru1632(*args)
        ref = stream.gru1632_plain(*args)
        serial = _serial_gru1632(*args)
    torch.cuda.synchronize()
    tol = 2.0 ** -5
    err = max(_max_err(a, b) for a, b in zip(got, ref))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, serial))
    n16, n32 = h16 * w16, h32 * w32
    macs = n32 * _gru_macs(ch, ch) + n16 * _gru_macs(ch, 2 * ch)
    wbytes = 2 * (9 * (2 * ch) * 3 * ch + 9 * (3 * ch) * 3 * ch + 2 * 9 * ch * ch)
    nbytes = 2 * ((n16 + n32) * (ch + 3 * ch + ch + ch)) + wbytes
    bound_ms, bound_by = _bound(nbytes, 2.0 * macs, PEAK_BF16)

    def kernel():
        with torch.no_grad():
            stream.fused_gru1632(*args)

    def plain():
        with torch.no_grad():
            stream.gru1632_plain(*args)

    def chain():
        with torch.no_grad():
            _serial_gru1632(*args)

    return {"name": "gru1632", "counter": "gru1632", "tol": tol, "ok": err <= tol and bitwise,
            "max_abs_err": err, "bitwise_equal_serial": bitwise, **_timings(kernel, plain),
            "serial_ms": _device_ms(chain), "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": f"gru16 1x{h16}x{w16}, gru32 1x{h32}x{w32}, {ch} ch, bf16"}


def check_resident() -> dict:
    """Kernel 6 at the main path's shapes (96x312, 128 channels, the pyramid
    of 256-channel feature maps, x2 the upsampled gru16 state). Tolerances
    as for the GRU kernel with the head: 2^-5 for h', 2^-5 of the RMS of
    dx for dx; and bit for bit the serial CUDA chain (lookup, motion, GRU
    with the head)."""
    from raft_stereo_tpu_torch.corr import reg_cuda
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
    from raft_stereo_tpu_torch.ops import resident, stream
    g = _gen(14)
    ch, bf = 128, torch.bfloat16
    h, w = FEAT
    enc, gru, fh = BasicMotionEncoder(36), ConvGRU(ch, 2 * ch), FlowHead(ch, 256, 2)
    for i, m in enumerate((enc, gru, fh)):
        init_weights(m, torch.Generator().manual_seed(15 + i))
    enc, gru, fh = enc.cuda(), gru.cuda(), fh.cuda()
    ops = reg_cuda.build_corr_operands(_randn((1, h, w, 256), g), _randn((1, h, w, 256), g),
                                       num_levels=4, radius=4)
    coords = torch.rand((1, h, w), generator=g, device="cuda") * (w + 40) - 20
    flow = torch.cat([_randn((1, h, w, 1), g, 4.0),
                      torch.zeros((1, h, w, 1), device="cuda", dtype=bf)], -1)
    with torch.no_grad():
        args = (stream.motion_weights(enc, bf), stream.gru_weights(gru, bf, "gru08"),
                stream.head_weights(fh, bf), ops, _randn((1, h, w, ch), g, 0.5),
                stream.prepare_gru_context(gru, [_randn((1, h, w, ch), g, 0.3)
                                                 for _ in range(3)], bf),
                coords, flow, _randn((1, h, w, ch), g))
        got = resident.fused_iter(*args)
        ref = resident.fused_iter_plain(*args)

        def chain():
            corr = reg_cuda.lookup(ops, coords)
            motion = stream.fused_motion(args[0], flow, corr)
            return stream.fused_conv_gru(args[1], args[4], args[5], motion, args[8],
                                         head=args[2])

        serial = chain()
    torch.cuda.synchronize()
    tol = 2.0 ** -5
    err_h = _max_err(got[0], ref[0])
    dx_rms = float(ref[1].square().mean().sqrt())
    err_dx = _max_err(got[1], ref[1])
    bitwise = all(torch.equal(a, b) for a, b in zip(got, serial))
    npix, k = h * w, 9
    motion_macs = 36 * 64 + 49 * 64 + 2 * 9 * 64 * 64 + 9 * 128 * 126
    macs = npix * (motion_macs + _gru_macs(ch, 2 * ch) + 9 * (ch * 256 + 256))
    wbytes = 2 * (36 * 64 + 49 * 64 + 9 * 128 * 128 + 9 * 128 * 126 + 9 * 3 * ch * 3 * ch
                  + 9 * ch * ch + 9 * ch * 256 + 9 * 256)
    # coords, the 2r+2 taps of 4 levels, flow; h, czrq, x2; h' and dx out.
    nbytes = npix * (4 + 4 * (k + 1) * 2 + 2 * 2 + 2 * (ch + 3 * ch + ch) + 2 * ch + 4) + wbytes
    bound_ms, bound_by = _bound(nbytes, 2.0 * macs, PEAK_BF16)

    def kernel():
        with torch.no_grad():
            resident.fused_iter(*args)

    def plain():
        with torch.no_grad():
            resident.fused_iter_plain(*args)

    def serial_run():
        with torch.no_grad():
            chain()

    return {"name": "fused_iter", "counter": "fused_iter", "tol": tol,
            "ok": err_h <= tol and err_dx <= tol * dx_rms and bitwise,
            "max_abs_err": max(err_h, err_dx), "max_abs_err_h": err_h, "max_abs_err_dx": err_dx,
            "tol_dx": tol * dx_rms, "dx_rms": dx_rms, "bitwise_equal_serial": bitwise,
            **_timings(kernel, plain), "serial_ms": _device_ms(serial_run),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": f"1x{h}x{w}x{ch}, 4 levels r=4, x2 {ch}, bf16"}


def phase_kernels() -> list:
    from raft_stereo_tpu_torch.corr import reg_cuda
    from raft_stereo_tpu_torch.ops import stream
    from raft_stereo_tpu_torch.ops import resident
    results = [check_lookup(), check_gru("gru08"), check_gru("gru16"),
               check_gru("gru32"), check_motion(), check_gru1632(), check_resident()]
    sources = {"corr_lookup": ("raft_stereo_tpu_torch/csrc/corr_lookup.cu",
                               "raft_stereo_tpu/corr/pallas_reg.py:730", reg_cuda.lookup),
               "conv_gru": ("raft_stereo_tpu_torch/csrc/conv_gru.cu",
                            "raft_stereo_tpu/ops/pallas_stream.py:145",
                            stream.fused_conv_gru),
               "motion": ("raft_stereo_tpu_torch/csrc/motion.cu",
                          "raft_stereo_tpu/ops/pallas_stream.py:1218", stream.fused_motion),
               "gru1632": ("raft_stereo_tpu_torch/csrc/gru1632.cu",
                           "raft_stereo_tpu/ops/pallas_stream.py:686", stream.fused_gru1632),
               "fused_iter": ("raft_stereo_tpu_torch/csrc/resident.cu",
                              "raft_stereo_tpu/ops/pallas_resident.py:116",
                              resident.fused_iter)}
    failed = []
    for r in results:
        kernel = r["name"].split(":")[0]
        r["route"] = "cuda"
        r["source"], r["replaces"] = sources[kernel][:2]
        r["library_ms"] = None
        r["library_note"] = "no single PyTorch call computes this function"
        ok = r.pop("ok", r["max_abs_err"] <= r["tol"])
        print(json.dumps({"phase": "kernel", "ok": ok, **r}))
        if not ok:
            failed.append(r["name"])
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: {failed}")
    return results


def random_pairs(n: int, shape, seed: int):
    g = _gen(seed)
    return [(torch.rand((1, *shape, 3), generator=g, device="cuda") * 255,
             torch.rand((1, *shape, 3), generator=g, device="cuda") * 255)
            for _ in range(n)]


def seeded_model(device: str):
    """The default full-width model, weights from seed 0, flow head tempered."""
    from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda", mixed_precision=True)
    model = init_raft_stereo(cfg, seed=0, device=device)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.02)
        model.update_block.flow_head.conv2.bias.mul_(0.02)
    return model


def _drive(model, pairs, want: dict, path: str) -> tuple:
    """The demo's inference over ``pairs`` at full width, counts set to 0
    just before and read just after; each frame must launch exactly
    ``want``."""
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.demo import infer_pair
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    frame_ms, per_frame, disps = [], [], []
    for left, right in pairs:
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        disp = infer_pair(model, left, right, iters=ITERS)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: n - before.get(k, 0) for k, n in kernels.launches.items()
                  if n != before.get(k, 0)}
        per_frame.append(counts)
        shape = tuple(left.shape[1:3])
        if tuple(disp.shape) != shape or not bool(torch.isfinite(disp).all()):
            raise SystemExit(f"{path}: bad disparity: shape {tuple(disp.shape)}, "
                             f"finite {bool(torch.isfinite(disp).all())}")
        if counts != want:
            raise SystemExit(f"{path}: launches per frame {counts}, expected {want}")
        disps.append(disp)
    result = {"phase": "main_path", "path": path, "frames": len(pairs), "iters": ITERS,
              "input": "x".join(map(str, pairs[0][0].shape[1:3])), "frame_ms": frame_ms,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": dict(kernels.launches), "launches_per_frame": per_frame,
              "disparity_mean_last": float(disps[-1].mean())}
    print(json.dumps(result))
    return result, disps


def phase_main_path() -> dict:
    """The demo's inference at full width: the default loop, the serial
    loop on the first pair again, and one headline-size frame. Every kernel
    of a loop must carry it, and the two loops must agree bit for bit."""
    model = seeded_model("cuda")
    pairs = random_pairs(N_FRAMES, KITTI, seed=7)
    default = {"fused_iter": ITERS, "gru1632": ITERS}
    serial = {"corr_lookup": ITERS, "motion": ITERS, "conv_gru:gru08": ITERS,
              "conv_gru:gru16": ITERS, "conv_gru:gru32": ITERS}
    for knob in SWITCHES:
        os.environ.pop(knob, None)
    run_default, disp_default = _drive(model, pairs, default, "default")
    try:
        for knob in SWITCHES:
            os.environ[knob] = "0"
        run_serial, disp_serial = _drive(model, pairs[:1], serial,
                                         "serial (RAFT_FUSE_ITER=0 RAFT_FUSE_GRU1632=0)")
    finally:
        for knob in SWITCHES:
            os.environ.pop(knob, None)
    same = torch.equal(disp_default[0], disp_serial[0])
    print(json.dumps({"phase": "default_vs_serial", "bitwise_equal": same,
                      "max_abs_diff": _max_err(disp_default[0], disp_serial[0])}))
    if not same:
        raise SystemExit("the default and serial loops give different disparities")
    headline, _ = _drive(model, random_pairs(1, MIDDLEBURY_F, seed=12), default,
                         "default, Middlebury-F")
    return {"default": run_default, "serial": run_serial, "headline": headline}


def phase_cross_check() -> dict:
    """The same seeded model at 128x256, 8 iterations, on the card and on
    the CPU (plain versions). Band: mean |delta| within the serving canary's
    absolute floor, 0.05 px, and every pixel within 0.25 px. The canary
    band itself (rtol 5e-3, atol 5e-2 per pixel) is printed but not held:
    it was set for trained weights, whose updates shrink as the loop
    converges, while the seeded model keeps moving ~0.7 px an iteration, so
    one-ulp bf16 differences (cuDNN against oneDNN convs, the kernels
    against their plain versions) add up over the 8 iterations at a few
    pixels. 0.25 px stays 4x under the 1 px D1 threshold, the tightest
    metric the evaluators use."""
    import numpy as np

    from raft_stereo_tpu_torch.demo import infer_pair
    (left, right), = random_pairs(1, (128, 256), seed=8)
    out = {}
    for dev in ("cuda", "cpu"):
        model = seeded_model(dev)
        out[dev] = infer_pair(model, left.to(dev), right.to(dev), iters=8).float().cpu()
    d = (out["cuda"] - out["cpu"]).abs()
    in_canary = np.isclose(out["cuda"].numpy(), out["cpu"].numpy(), rtol=5e-3, atol=5e-2)
    mean_tol, max_tol = 0.05, 0.25
    ok = float(d.mean()) <= mean_tol and float(d.max()) <= max_tol
    result = {"phase": "cross_check", "ok": ok, "mean_abs_diff": float(d.mean()),
              "max_abs_diff": float(d.max()), "mean_tol": mean_tol, "max_tol": max_tol,
              "canary_fraction": float(in_canary.mean()),
              "disparity_abs_mean": float(out["cpu"].abs().mean())}
    print(json.dumps(result))
    if not ok:
        raise SystemExit("card and CPU disparities disagree beyond the band")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import raft_stereo_tpu_torch  # noqa: F401  (fails when run without the repo)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_device()
    phase_build()
    results = phase_kernels()
    main_path = phase_main_path()
    phase_cross_check()
    line = []
    for r in results:
        run = main_path["default" if r["counter"] in main_path["default"]["launches"]
                        else "serial"]
        line.append({"name": r["name"], "route": r["route"], "source": r["source"],
                     "replaces": r["replaces"], "path": run["path"], "frames": run["frames"],
                     "launches": run["launches"].get(r["counter"], 0),
                     "launches_per_frame": run["launches_per_frame"][0].get(r["counter"], 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "wrapper_ms": r["wrapper_ms"], "plain_ms": r["plain_ms"],
                     "serial_ms": r.get("serial_ms"),
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": None, "library_note": r["library_note"]})
        if line[-1]["launches"] == 0:
            raise SystemExit(f"kernel {r['name']} was launched no time on its path")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
