#!/usr/bin/env python3
"""Time the encoder's 3x3 pass rows of chip_smoke.py phase 3 for one tree.

    python3 scripts/time_enc_pass.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of the port, such as
a `git archive` of a parent commit unpacked under build/: its chip_smoke.py
and its kernels are the ones timed, so running a parent and a change in turns
in one call compares the two on one card. Prints the card, then one JSON line
per pass row (the bf16 pass at both main paths' shapes in both norms and the
quantize-on-exit pass at the zqr shapes: device ms, the hand-written
kernels' ms, the plain version's, F.conv2d's, the bound), then the device
time by kernel name of calls that the rows leave summed: a 64-channel pass
with and without statistics, a 96-channel one with statistics, and the q8
pass beside its bf16 pass (weights laid out each call there, as a tree
without prepared weights does). Needs a CUDA card.
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


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_enc_pass: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from raft_stereo_tpu_torch.ops import encoder as enc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), "tree", root)
    rows = []
    for path, (full, half, quarter) in cs.SHAPES.items():
        for stats in (False, True):
            rows += [cs.check_pass(path, *full, 64, kind, stats) for kind in ("mid1", "mid2")]
            rows += [cs.check_pass(path, h, w, ch, kind, stats)
                     for (h, w), ch in ((half, 96), (quarter, 128)) for kind in ("raw1", "mid1")]
        torch.cuda.empty_cache()
    (h, w), (hh, wh) = cs.FEAT, cs.ALT_HEADLINE_FEAT
    rows += [cs.check_pass_q8("lane8", h // k, w // k) for k in (1, 2, 4)]
    rows.append(cs.check_pass_q8("lane8_headline", hh, wh))
    keys = ("name", "ok", "ms", "kernel_ms", "bf16_ms", "plain_ms", "library_ms", "bound_ms")
    for r in rows:
        print(json.dumps({k: r.get(k) for k in keys}))
    g = cs._gen(22)
    calls = (((2016, 2976), 64, "mid1", True), ((2016, 2976), 64, "mid1", False),
             ((1008, 1488), 96, "raw1", True))
    for (hh, ww), ch, kind, st in calls:
        inputs = [cs._enc_triple(g, (1, hh, ww, ch), st and kind != "raw1")]
        wt, b = cs._enc_weights(ch, ch, 3, 23)
        print(json.dumps({"call": f"{kind}/{'instance' if st else 'bn'}/{ch} {hh}x{ww}",
                          "ms_by_kernel": _by_kernel(
                              lambda: enc.conv_pass(kind, inputs, wt, b, stats=st))}))
    for hh, ww in (cs.FEAT, cs.ALT_HEADLINE_FEAT):
        x = [(torch.relu(cs._randn((1, hh, ww, 128), g)), None, None)]
        wt, b = cs._enc_weights(128, 384, 3, 27)
        for quant in (True, False):
            print(json.dumps({"call": f"raw1 128->384{' q8' if quant else ''} {hh}x{ww}",
                              "ms_by_kernel": _by_kernel(
                                  lambda: enc.conv_pass("raw1", x, wt, b, stats=False,
                                                        quant=quant))}))
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
