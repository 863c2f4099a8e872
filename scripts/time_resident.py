#!/usr/bin/env python3
"""Time the resident iteration and its serial twins for one tree.

    python3 scripts/time_resident.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of the port, such as
a `git archive` of a parent commit unpacked under build/: its chip_smoke.py
and its kernels are the ones timed, so running a parent and a change in turns
in one call compares the two on one card. Prints the card, then one JSON line
per row of chip_smoke.py phase 3 that the resident kernel and its serial
twins give (the resident kernel in its bf16, pack8 and lane8 modes, gru08 +
head, motion: device ms, the serial chain's, the plain version's, the
bound), then the device time by kernel name of one resident call and of the
serial chain it is pinned against (lookup, motion, gru08 + head) at the
KITTI and Middlebury-F finest-level shapes (96x312 and 504x744). Needs a
CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def _by_kernel(fn, reps: int = 5) -> dict:
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


def _case(cs, h: int, w: int):
    """The resident kernel's arguments at one finest-level shape, as
    chip_smoke.py's check_resident builds them (128 channels, 4 levels of a
    256-channel pyramid, radius 4, one x2 part)."""
    import torch
    from raft_stereo_tpu_torch.corr import reg_cuda
    from raft_stereo_tpu_torch.models.layers import init_weights
    from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
    from raft_stereo_tpu_torch.ops import stream
    g = cs._gen(14)
    ch, bf = 128, torch.bfloat16
    enc, gru, fh = BasicMotionEncoder(36), ConvGRU(ch, 2 * ch), FlowHead(ch, 256, 2)
    for i, m in enumerate((enc, gru, fh)):
        init_weights(m, torch.Generator().manual_seed(15 + i))
    enc, gru, fh = enc.cuda(), gru.cuda(), fh.cuda()
    ops = reg_cuda.build_corr_operands(cs._randn((1, h, w, 256), g), cs._randn((1, h, w, 256), g),
                                       num_levels=4, radius=4)
    coords = torch.rand((1, h, w), generator=g, device="cuda") * (w + 40) - 20
    flow = torch.cat([cs._randn((1, h, w, 1), g, 4.0),
                      torch.zeros((1, h, w, 1), device="cuda", dtype=bf)], -1)
    with torch.no_grad():
        return (stream.motion_weights(enc, bf), stream.gru_weights(gru, bf, "gru08"),
                stream.head_weights(fh, bf), ops, cs._randn((1, h, w, ch), g, 0.5),
                stream.prepare_gru_context(gru, [cs._randn((1, h, w, ch), g, 0.3)
                                                 for _ in range(3)], bf),
                coords, flow, cs._randn((1, h, w, ch), g))


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_resident: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from raft_stereo_tpu_torch.corr import reg_cuda
    from raft_stereo_tpu_torch.ops import resident, stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), "tree", root)
    rows = [cs.check_resident(), cs.check_resident(pack8=True), cs.check_resident(lane8=True),
            cs.check_gru("gru08"), cs.check_motion()]
    keys = ("name", "ok", "max_abs_err", "bitwise_equal_serial", "ms", "kernel_ms", "serial_ms",
            "wrapper_ms", "bf16_ms", "plain_ms", "bound_ms")
    for r in rows:
        print(json.dumps({k: r.get(k) for k in keys}))
    for h, w in (cs.FEAT, cs.ALT_HEADLINE_FEAT):
        args = _case(cs, h, w)
        mw, gw, hw, ops, hst, czrq, coords, flow, x2 = args

        def serial():
            with torch.no_grad():
                motion = stream.fused_motion(mw, flow, reg_cuda.lookup(ops, coords))
                stream.fused_conv_gru(gw, hst, czrq, motion, x2, head=hw)

        def fused():
            with torch.no_grad():
                resident.fused_iter(*args)

        for name, fn in (("resident", fused), ("serial", serial)):
            print(json.dumps({"call": f"{name} {h}x{w}", "ms_by_kernel": _by_kernel(fn)}))
        del args, ops
        torch.cuda.empty_cache()
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
