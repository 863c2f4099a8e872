#!/usr/bin/env python3
"""Where one frame's device time goes in the PyTorch/CUDA port.

    python3 scripts/profile_torch_port.py

Runs chip_smoke.py's main path (the seeded full-width model, bf16,
reg_cuda, one random 375x1242 pair padded to 384x1248, 32 iterations) twice
to warm up, then once under torch.profiler, and prints JSON lines:
- the card (nvidia-smi name and power limit);
- the frame's host wall ms, the device-busy ms (union of kernel intervals)
  and the idle share of the frame's window;
- device ms by group: the port's CUDA kernels (lookup, GRU engine, motion
  stage 1), convolutions and matmuls from the libraries, everything else;
- the top kernels by device time, with their launch counts;
- the library matmuls' device ms by the torch op that launched them;
- device ms per call of the corr volume and pyramid and of the two
  per-iteration resizes, each run alone.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402


def _group(name: str) -> str:
    n = name.lower()
    if "corr_lookup_kernel" in n:
        return "port:corr_lookup"
    if "conv3x3_kernel" in n:
        return "port:conv3x3 engine (GRU, motion stages 2-3)"
    if "motion_stage1" in n:
        return "port:motion stage 1"
    # cuDNN's convolutions are implicit GEMMs ("fprop", "implicit_gemm"), so
    # they are told apart before the matmuls, whose names say gemm too.
    if any(s in n for s in ("conv", "cudnn", "fprop", "implicit")):
        return "library conv"
    if any(s in n for s in ("gemm", "cutlass", "cublas", "nvjet", "xmma")):
        return "library matmul"
    return "other (elementwise, reductions, copies)"


def _busy_ms(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.demo import infer_pair
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__}))
    kernels.build()
    model = chip_smoke.seeded_model("cuda")
    (left, right), = chip_smoke.random_pairs(1, chip_smoke.KITTI, seed=9)
    for _ in range(2):
        infer_pair(model, left, right, iters=chip_smoke.ITERS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer_pair(model, left, right, iters=chip_smoke.ITERS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    intervals = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = evt.time_range.end - evt.time_range.start
        by_name[evt.name][0] += dur / 1e3
        by_name[evt.name][1] += 1
        intervals.append((evt.time_range.start, evt.time_range.end))
    if not intervals:
        raise SystemExit("the profiler recorded no device activity")
    busy = _busy_ms(intervals)
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)) / 1e3
    groups = defaultdict(float)
    for name, (ms, _) in by_name.items():
        groups[_group(name)] += ms
    print(json.dumps({"frame_wall_ms": wall_ms, "device_busy_ms": busy,
                      "device_window_ms": window,
                      "idle_share_of_wall": 1.0 - busy / wall_ms,
                      "kernel_launches": sum(c for _, c in by_name.values())}))
    print(json.dumps({"device_ms_by_group": dict(sorted(groups.items(),
                                                        key=lambda kv: -kv[1]))}))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, count) in top:
        print(json.dumps({"kernel": name[:120], "device_ms": ms, "launches": count}))
    print(json.dumps({"library_matmul_by_op": _matmul_owners(prof)}))
    print(json.dumps({"alone": _alone()}))
    return 0


def _matmul_owners(prof) -> dict:
    """The library matmul group's device ms and launches by the outermost
    torch op that launched them (einsum of the resize, matmul of the
    volume, ...), from the profiler's links of kernels to CPU ops."""
    owners = defaultdict(lambda: [0.0, 0, set()])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or not evt.kernels:
            continue
        owner, e = evt.name, evt
        while e is not None:
            if e.name.startswith("aten::"):
                owner = e.name
            e = e.cpu_parent
        for k in evt.kernels:
            if _group(k.name) == "library matmul":
                owners[owner][0] += k.duration / 1e3
                owners[owner][1] += 1
                owners[owner][2].add(k.name[:80])
    return {name: {"device_ms": ms, "launches": n, "kernels": sorted(names)}
            for name, (ms, n, names) in owners.items()}


def _alone() -> dict:
    """Device ms per call of the per-frame volume and pyramid and of the two
    per-iteration resizes, each alone at the main path's shapes."""
    import chip_smoke
    from raft_stereo_tpu_torch.corr import reg_cuda
    from raft_stereo_tpu_torch.ops.resize import interp_align_corners
    g = torch.Generator(device="cuda").manual_seed(10)
    h, w = chip_smoke.FEAT
    f1, f2 = (torch.randn((1, h, w, 256), generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    n16 = torch.randn((1, h // 2, w // 2, 128), generator=g, device="cuda").to(torch.bfloat16)
    n32 = torch.randn((1, h // 4, w // 4, 128), generator=g, device="cuda").to(torch.bfloat16)
    return {
        "corr_volume_and_pyramid": chip_smoke._device_ms(
            lambda: reg_cuda.build_corr_operands(f1, f2, num_levels=4, radius=4)),
        "resize_gru32_to_gru16": chip_smoke._device_ms(
            lambda: interp_align_corners(n32, (h // 2, w // 2))),
        "resize_gru16_to_gru08": chip_smoke._device_ms(
            lambda: interp_align_corners(n16, (h, w)))}


if __name__ == "__main__":
    sys.exit(main())
