#!/usr/bin/env python3
"""Time the gru16+32 kernel and the serial chain it is pinned against, for
one tree.

    python3 scripts/time_gru1632.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of the port, such as
a `git archive` of a parent commit unpacked under build/: its chip_smoke.py
and its kernels are the ones timed, so running a parent and a change in turns
in one call (parent, change, change, parent) compares the two on one card.
Prints the card and the tree, then one JSON line for each of the KITTI
(gru16 48x156, gru32 24x78) and Middlebury-F (252x372, 126x186) shapes, with
bf16 and with int8 czrq (RAFT_LANE_PACK8): the device ms a call of the
gru16+32 kernel, of the serial chain (the head-less gru32 and gru16 steps
and the resize between), of each head-less step alone, whether the kernel
equals the chain bit for bit; then, for each shape and mode, the device
time by kernel name of one call of the kernel and of the chain. 20 calls
after 3 at KITTI, 5 after 1 at Middlebury-F. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def _by_kernel(fn, reps: int) -> dict:
    """Device ms a call by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total[e.name[:60]] = total.get(e.name[:60], 0) + e.time_range.end - e.time_range.start
    return {k: v / reps / 1e3 for k, v in sorted(total.items(), key=lambda kv: -kv[1])}


def _case(cs, h16: int, w16: int, lane8: bool):
    """gru16+32's arguments at one shape, as chip_smoke.py's check_gru1632
    builds them (128 channels, seeded weights and inputs)."""
    import torch
    from raft_stereo_tpu_torch.corr.reg_cuda import quantize_feature8
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import ConvGRU
    from raft_stereo_tpu_torch.ops import stream
    g = cs._gen(11)
    ch, bf = 128, torch.bfloat16
    h32, w32 = h16 // 2, w16 // 2
    g16, g32 = ConvGRU(ch, 2 * ch), ConvGRU(ch, ch)
    init_weights(g16, torch.Generator().manual_seed(12))
    init_weights(g32, torch.Generator().manual_seed(13))
    g16, g32 = g16.cuda(), g32.cuda()
    with torch.no_grad():
        czrq16 = stream.prepare_gru_context(g16, [cs._randn((1, h16, w16, ch), g, 0.3)
                                                  for _ in range(3)], bf)
        czrq32 = stream.prepare_gru_context(g32, [cs._randn((1, h32, w32, ch), g, 0.3)
                                                  for _ in range(3)], bf)
        if lane8:
            czrq16, czrq32 = quantize_feature8(czrq16), quantize_feature8(czrq32)
        return (stream.gru_weights(g16, bf, "gru16"), stream.gru_weights(g32, bf, "gru32"),
                cs._randn((1, h16, w16, ch), g, 0.5), cs._randn((1, h32, w32, ch), g, 0.5),
                czrq16, czrq32, cs._randn((1, h16, w16, ch), g), cs._randn((1, h32, w32, ch), g))


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_gru1632: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.ops import stream
    from raft_stereo_tpu_torch.ops.resize import interp_align_corners
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), "tree", root)
    print(json.dumps({"build_seconds": kernels.build(["conv_gru", "gru1632"])}))
    ok, breakdowns = True, []
    for h16, w16 in ((cs.FEAT[0] // 2, cs.FEAT[1] // 2),
                     (cs.ALT_HEADLINE_FEAT[0] // 2, cs.ALT_HEADLINE_FEAT[1] // 2)):
        reps, warmup = (20, 3) if h16 * w16 <= 48 * 156 else (5, 1)
        for lane8 in (False, True):
            args = _case(cs, h16, w16, lane8)
            w16_, w32_, hs16, hs32, c16, c32, x0p, x1p = args
            with torch.no_grad():
                up = interp_align_corners(stream.fused_conv_gru(w32_, hs32, c32, x1p)[0],
                                          (h16, w16))
                bitwise = all(torch.equal(a, b) for a, b in zip(
                    stream.fused_gru1632(*args), cs._serial_gru1632(*args)))
            ok = ok and bitwise

            def fused(args=args):
                with torch.no_grad():
                    stream.fused_gru1632(*args)

            def serial(args=args):
                with torch.no_grad():
                    cs._serial_gru1632(*args)

            def gru32():
                with torch.no_grad():
                    stream.fused_conv_gru(w32_, hs32, c32, x1p)

            def gru16():
                with torch.no_grad():
                    stream.fused_conv_gru(w16_, hs16, c16, x0p, up)

            case = {"shape": f"gru16 {h16}x{w16}, gru32 {h16 // 2}x{w16 // 2}",
                    "czrq": "int8" if lane8 else "bf16"}
            print(json.dumps({
                **case, "bitwise_equal_serial": bitwise,
                "ms": cs._device_ms(fused, reps, warmup),
                "serial_ms": cs._device_ms(serial, reps, warmup),
                "gru32_ms": cs._device_ms(gru32, reps, warmup),
                "gru16_ms": cs._device_ms(gru16, reps, warmup)}))
            breakdowns.append((case, fused, serial, reps))
    for case, fused, serial, reps in breakdowns:
        print(json.dumps({**case, "ms_by_kernel": _by_kernel(fused, reps),
                          "serial_ms_by_kernel": _by_kernel(serial, reps)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
