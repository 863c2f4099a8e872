#!/usr/bin/env python3
"""Time the correlation lookup and the point2 q8 exit for one tree.

    python3 scripts/time_lookup_point2q8.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of the port, such as
a `git archive` of a parent commit unpacked under build/: its kernels are the
ones built and timed, so running a parent and a change in turns in one call
(parent, change, change, parent) compares the two on one card. The inputs
and the timing helpers are this checkout's chip_smoke.py (and the resident
case of scripts/time_resident.py), so both trees see the same inputs. Prints
the card and the tree, then one JSON line a case:
- the lookup (corr/reg_cuda.py lookup, 4 levels of a 256-channel pyramid,
  radius 4), bf16 and int8 levels (RAFT_CORR_PACK8), at 96x312 and 504x744,
  on coordinates spread uniformly past both ends of the row (chip_smoke.py's
  correctness case) and on a frame-like field (chip_smoke.py frame_coords):
  equal bits to the plain version, device ms a call (torch.profiler), the ms
  a call of a back-to-back loop between CUDA events, the wall ms of the
  Python wrapper (CUDA events around the call) and its host ms (200 calls
  enqueued back to back, the host clock up to the last enqueue);
- point2 q8 (ops/encoder.py point2, quant=True) at 96x312x128 and
  504x744x128, folded BatchNorm ("bn") and instance norm ("in"): equal bits
  to the host quantization of the bf16 exit, the same timings, and the
  kernels, fills and copies a call puts on the card;
- the resident kernel (ops/resident.py fused_iter) at 96x312, device ms;
- whole frames: chip_smoke.py's seeded model and random pairs through the
  demo's inference function (32 iterations, reg_cuda): the KITTI pair on
  the default loop and on the serial loop (RAFT_FUSE_ITER=0
  RAFT_FUSE_GRU1632=0: 32 lookups a frame), the Middlebury-F pair on the
  default loop: the device ms of a frame (torch.profiler's kernel time, 2
  frames after 1).
20 calls after 3 for every kernel case. Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _host_ms(torch, fn, reps: int = 200) -> float:
    """Host milliseconds a call: ``reps`` calls enqueued back to back, timed
    on the host clock up to the last enqueue (the card runs behind)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e3


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()
    # The tree under test first, so its package is the one imported; then
    # this checkout's chip_smoke.py, by its path, for the inputs and timers.
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_lookup_point2q8: CUDA is not available", file=sys.stderr)
        return 2
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.corr import reg_cuda
    from raft_stereo_tpu_torch.corr.reg_cuda import quantize_feature8
    from raft_stereo_tpu_torch.demo import infer_pair
    from raft_stereo_tpu_torch.ops import encoder as enc
    from raft_stereo_tpu_torch.ops import resident
    cs = _load("chip_smoke_here", HERE / "chip_smoke.py")
    tr = _load("time_resident_here", HERE / "scripts" / "time_resident.py")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), "tree", root)
    print(json.dumps({"build_seconds": kernels.build(["corr_lookup", "enc_point", "resident"])}))
    ok = True

    def timed(fn) -> dict:
        return {"ms": cs._device_ms(fn), "events_ms": cs._events_ms(fn),
                "wrapper_ms": cs._wall_ms(fn), "host_ms": _host_ms(torch, fn)}

    for pack8 in (False, True):
        for h, w in (cs.FEAT, cs.ALT_HEADLINE_FEAT):
            g = cs._gen(1)
            f1, f2 = cs._randn((1, h, w, 256), g), cs._randn((1, h, w, 256), g)
            ops = cs._with_env({"RAFT_CORR_PACK8": "1" if pack8 else "0"},
                               lambda: reg_cuda.build_corr_operands(f1, f2, num_levels=4,
                                                                    radius=4))
            del f1, f2
            uniform = torch.rand((1, h, w), generator=g, device="cuda") * (w + 40) - 20
            fields = {"uniform": uniform, "frame": cs.frame_coords(g, h, w)}
            for name, coords in fields.items():
                equal = torch.equal(reg_cuda.lookup(ops, coords),
                                    reg_cuda.lookup_plain(ops, coords))
                ok &= equal
                print(json.dumps({"kernel": "corr_lookup", "levels": "int8" if pack8 else "bf16",
                                  "shape": f"{h}x{w}", "coords": name, "equal_plain": equal,
                                  **timed(lambda: reg_cuda.lookup(ops, coords))}))
            del ops, fields, uniform
            torch.cuda.empty_cache()
    for h, w in (cs.FEAT, cs.ALT_HEADLINE_FEAT):
        g = cs._gen(29)
        shape = (1, h, w, 128)
        x, y = cs._randn(shape, g), cs._enc_triple(g, shape, True)
        for norm in (False, True):
            def kernel():
                return enc.point2(x, y, norm=norm, quant=True)

            lane, host = kernel(), quantize_feature8(enc.point2(x, y, norm=norm))
            equal = torch.equal(lane.q, host.q) and torch.equal(lane.scale, host.scale)
            ok &= equal
            print(json.dumps({"kernel": "enc_point2 q8", "norm": "in" if norm else "bn",
                              "shape": f"{h}x{w}x128", "equal_host_quantization": equal,
                              "launches_per_call": cs._launches_per_call(kernel),
                              **timed(kernel)}))
        del x, y
        torch.cuda.empty_cache()
    args = tr._case(cs, *cs.FEAT)

    def fused():
        with torch.no_grad():
            resident.fused_iter(*args)

    print(json.dumps({"kernel": "fused_iter", "shape": "96x312", "ms": cs._device_ms(fused),
                      "events_ms": cs._events_ms(fused)}))
    del args
    model = cs.seeded_model("cuda")
    for size, shape, seed, loop in (("KITTI", cs.KITTI, 9, "default"),
                                    ("KITTI", cs.KITTI, 9, "serial"),
                                    ("Middlebury-F", cs.MIDDLEBURY_F, 12, "default")):
        (left, right), = cs.random_pairs(1, shape, seed=seed)
        env = dict.fromkeys(cs.SWITCHES, "0") if loop == "serial" else {}
        ms = cs._with_env(env, lambda: cs._device_ms(
            lambda: infer_pair(model, left, right, iters=cs.ITERS), 2, 1))
        print(json.dumps({"frame": size, "loop": loop, "device_ms": ms}))
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
