#!/usr/bin/env python3
"""Time the alt correlation kernel and the encoders' stem for one tree.

    python3 scripts/time_alt_stem.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of the port, such as
a `git archive` of a parent commit unpacked under build/: its kernels are the
ones built and timed, so running a parent and a change in turns in one call
(parent, change, change, parent) compares the two on one card. The inputs
and the timing helpers are this checkout's chip_smoke.py, so both trees see
the same inputs. Prints the card and the tree, then one JSON line a case:
- the alt kernel (corr/alt_cuda.py lookup, bf16, D = 256, 4 levels, radius
  4) at 96x312 and 504x744, with coordinates spread uniformly past both
  ends of the row (chip_smoke.py's correctness case) and with a frame-like
  field (chip_smoke.py frame_coords);
- the stem (ops/encoder.py stem) at 384x1248 and 2016x2976, without
  statistics (the context net's "bn") and with them (the feature net's
  "in");
each with the device ms a call (torch.profiler), the ms a call of a
back-to-back loop between CUDA events, and the largest error against the
plain version in bf16 ulps. 20 calls after 3 at the KITTI shapes, 5 after 1
at Middlebury-F. Then whole frames: chip_smoke.py's seeded model and random
pairs through the demo's inference function (32 iterations), the KITTI and
the Middlebury-F pair, reg_cuda (one stem a KITTI frame, three a
Middlebury-F one) and alt_cuda (32 alt lookups a frame besides): the device
ms of a frame (torch.profiler's kernel time, 2 frames after 1). Needs a
CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()
    # The tree under test first, so its package is the one imported; then
    # this checkout's chip_smoke.py, by its path (a parent tree has one of
    # its own), for the inputs and the timers.
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_alt_stem: CUDA is not available", file=sys.stderr)
        return 2
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.corr import alt_cuda
    from raft_stereo_tpu_torch.ops import encoder as enc
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), "tree", root)
    print(json.dumps({"build_seconds": kernels.build(["corr_alt", "enc_stem"])}))
    for h, w in (cs.FEAT, cs.ALT_HEADLINE_FEAT):
        reps, warmup = (20, 3) if h * w <= cs.FEAT[0] * cs.FEAT[1] else (5, 1)
        g = cs._gen(2)
        f1, f2 = cs._randn((1, h, w, 256), g), cs._randn((1, h, w, 256), g)
        ops = alt_cuda.build_alt_operands(f1, f2, num_levels=4, radius=4)
        fields = {"uniform": torch.rand((1, h, w), generator=g, device="cuda") * (w + 40) - 20,
                  "frame": cs.frame_coords(g, h, w)}
        for name, coords in fields.items():
            with torch.no_grad():
                got = alt_cuda.lookup(ops, coords)
                ref = alt_cuda.lookup_plain(ops, coords)
            print(json.dumps({
                "kernel": "corr_alt", "shape": f"{h}x{w}x256", "coords": name,
                "max_ulps": cs._ulp_err(got, ref)[0],
                "ms": cs._device_ms(lambda: alt_cuda.lookup(ops, coords), reps, warmup),
                "events_ms": cs._events_ms(lambda: alt_cuda.lookup(ops, coords), reps,
                                           warmup)}))
        del f1, f2, ops
        torch.cuda.empty_cache()
    for path, (full, _, _) in cs.SHAPES.items():
        h, w = full
        reps, warmup = (20, 3) if path == "default" else (5, 1)
        g = cs._gen(20)
        x = (torch.rand((1, h, w, 3), generator=g, device="cuda") * 2 - 1).to(torch.bfloat16)
        wt, b = cs._enc_weights(3, 64, 7, 21)
        cw = enc.ConvWeights(wt, b)
        for stats in (False, True):
            got, _ = enc.stem(x, cw, None, stats=stats)
            ref, _ = enc.stem_plain(x, wt, b, stats=stats)
            print(json.dumps({
                "kernel": "enc_stem", "shape": f"{h}x{w}x3->64",
                "norm": "in" if stats else "bn", "max_ulps": cs._ulp_err(got, ref)[0],
                "ms": cs._device_ms(lambda: enc.stem(x, cw, None, stats=stats), reps, warmup),
                "events_ms": cs._events_ms(lambda: enc.stem(x, cw, None, stats=stats), reps,
                                           warmup)}))
        torch.cuda.empty_cache()
    from raft_stereo_tpu_torch.demo import infer_pair
    for size, shape, seed in (("KITTI", cs.KITTI, 9), ("Middlebury-F", cs.MIDDLEBURY_F, 12)):
        (left, right), = cs.random_pairs(1, shape, seed=seed)
        for corr in ("reg_cuda", "alt_cuda"):
            model = cs.seeded_model("cuda", corr)
            ms = cs._device_ms(lambda: infer_pair(model, left, right, iters=cs.ITERS), 2, 1)
            print(json.dumps({"frame": size, "corr": corr, "device_ms": ms}))
            del model
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
