#!/usr/bin/env python3
"""Where one frame's device time goes in the PyTorch/CUDA port.

    python3 scripts/profile_torch_port.py [slow_fast]

Runs chip_smoke.py's main path (the seeded full-width model, bf16,
reg_cuda, one random 375x1242 pair padded to 384x1248, 32 iterations) twice
to warm up, then once under torch.profiler, first on the default path,
then with the plain encoders (RAFT_FUSED_ENCODERS=0), then with the int8
context lanes (RAFT_LANE_PACK8=1), then with ``alt_cuda`` (the same
weights), and prints JSON lines, for each of the four:
- the card (nvidia-smi name and power limit), once;
- the frame's host wall ms, the device-busy ms (union of kernel intervals)
  and the idle share of the frame's window;
- device ms by group: the port's CUDA kernels (lookup, GRU engine, motion
  stage 1, the persistent loop kernels, the encoder kernels), convolutions
  and matmuls from the libraries, everything else;
- the top kernels by device time, with their launch counts;
- the library matmuls' device ms by the torch op that launched them;
- device ms of the prepare step alone (encoders and zqr convs), by group;
and once, device ms per call of the corr volume and pyramid, of the alt
path's pooled fmap2 pyramid and of the two per-iteration resizes, each run
alone. Then chip_smoke.py's Middlebury-F pair (2016x2976) with and without
RAFT_LANE_PACK8=1: the same records for one frame of each, and the host
wall ms of eight frames taken in turns (bf16, lane8, lane8, bf16, twice),
so the two are compared inside one call; then the same pair with
``alt_cuda``, the reference's own Middlebury command (the alt correlation
at full resolution), one frame's records.

With ``slow_fast``, only the slow-fast frames, the same records for each:
the reference's realtime model (chip_smoke.REALTIME: shared backbone,
1/8 resolution, 2 GRU levels, 7 iterations) and the default model with
``slow_fast_gru``, on the KITTI pair.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from raft_stereo_tpu_torch.obs.profiler import busy_seconds  # noqa: E402


def _group(name: str) -> str:
    n = name.lower()
    if "corr_lookup_kernel" in n:
        return "port:corr_lookup"
    if "corr_alt_bf16_kernel" in n or "corr_alt_f32_kernel" in n:
        return "port:corr_alt"
    if "loop_conv_kernel" in n:
        return "port:loop_conv_sm90 engine (motion stages 2-3, the GRU steps)"
    if "motion_stage1" in n:
        return "port:motion stage 1"
    if "gru1632_kernel" in n:
        return "port:gru1632 (gru32 + gru16)"
    if "resident_kernel" in n:
        return "port:resident (lookup + motion + gru08 + head)"
    if any(s in n for s in ("stem_sm90_kernel", "pass_sm90_kernel", "quant_map_kernel",
                            "point3_kernel", "point2_kernel", "stats_reduce")):
        return ("port:encoder kernels (stem, 3x3 pass and its q8 quantize pass, "
                "point3/point2, statistics)")
    # cuDNN's convolutions are implicit GEMMs ("fprop", "implicit_gemm"), so
    # they are told apart before the matmuls, whose names say gemm too.
    if any(s in n for s in ("conv", "cudnn", "fprop", "implicit")):
        return "library conv"
    if any(s in n for s in ("gemm", "cutlass", "cublas", "nvjet", "xmma")):
        return "library matmul"
    return "other (elementwise, reductions, copies)"


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from raft_stereo_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__}))
    kernels.build()
    (left, right), = chip_smoke.random_pairs(1, chip_smoke.KITTI, seed=9)
    if argv == ["slow_fast"]:
        _profile_frame("realtime", chip_smoke.seeded_model("cuda", **chip_smoke.REALTIME), left,
                       right, chip_smoke.RT_ITERS)
        _profile_frame("slow-fast", chip_smoke.seeded_model("cuda", slow_fast_gru=True), left,
                       right)
        return 0
    if argv:
        raise SystemExit(f"usage: {sys.argv[0]} [slow_fast]")
    model = chip_smoke.seeded_model("cuda")
    for route, env in (("default", {}), ("plain encoders", {"RAFT_FUSED_ENCODERS": "0"}),
                       ("lane8", {"RAFT_LANE_PACK8": "1"}), ("alt_cuda", {})):
        if route == "alt_cuda":
            model = chip_smoke.seeded_model("cuda", "alt_cuda")
        os.environ.update(env)
        try:
            _profile_frame(route, model, left, right)
        finally:
            for knob in env:
                os.environ.pop(knob, None)
    print(json.dumps({"alone": _alone()}))
    model = chip_smoke.seeded_model("cuda")
    (left, right), = chip_smoke.random_pairs(1, chip_smoke.MIDDLEBURY_F, seed=12)
    lane = {"RAFT_LANE_PACK8": "1"}
    for route, env in (("Middlebury-F", {}), ("Middlebury-F lane8", lane)):
        chip_smoke._with_env(env, lambda: _profile_frame(route, model, left, right))
    print(json.dumps({"route": "Middlebury-F, bf16 and lane8 in turns",
                      "frame_wall_ms": _in_turns(model, left, right, lane)}))
    del model
    torch.cuda.empty_cache()
    _profile_frame("Middlebury-F alt_cuda", chip_smoke.seeded_model("cuda", "alt_cuda"), left,
                   right)
    return 0


def _in_turns(model, left, right, env: dict) -> dict:
    """Host wall ms of frames without and with ``env``, in the order
    off, on, on, off, twice."""
    import chip_smoke
    from raft_stereo_tpu_torch.demo import infer_pair

    def frame_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer_pair(model, left, right, iters=chip_smoke.ITERS)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {"off": [], "on": []}
    for key in ("off", "on", "on", "off") * 2:
        out[key].append(chip_smoke._with_env(env if key == "on" else {}, frame_ms))
    return out


def _events(prof):
    """Device events of a profile: ms and launches by kernel name, and the
    intervals."""
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
    return by_name, intervals


def _by_group(by_name) -> dict:
    groups = defaultdict(float)
    for name, (ms, _) in by_name.items():
        groups[_group(name)] += ms
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def _profile_frame(route: str, model, left, right, iters: int = 32) -> None:
    from raft_stereo_tpu_torch import raft_stereo_prepare
    from raft_stereo_tpu_torch.demo import infer_pair
    from raft_stereo_tpu_torch.ops.padder import InputPadder
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        infer_pair(model, left, right, iters=iters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer_pair(model, left, right, iters=iters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, intervals = _events(prof)
    busy = busy_seconds(intervals) * 1e3
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)) / 1e3
    print(json.dumps({"route": route, "frame_wall_ms": wall_ms, "device_busy_ms": busy,
                      "device_window_ms": window,
                      "idle_share_of_wall": 1.0 - busy / wall_ms,
                      "kernel_launches": sum(c for _, c in by_name.values())}))
    print(json.dumps({"route": route, "device_ms_by_group": _by_group(by_name)}))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, count) in top:
        print(json.dumps({"route": route, "kernel": name[:120], "device_ms": ms,
                          "launches": count}))
    print(json.dumps({"route": route, "library_matmul_by_op": _matmul_owners(prof)}))
    padded = InputPadder(left.shape, divis_by=32).pad(left, right)
    raft_stereo_prepare(model, *padded)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        raft_stereo_prepare(model, *padded)
        torch.cuda.synchronize()
    by_name, intervals = _events(prof)
    print(json.dumps({"route": route, "prepare_device_busy_ms": busy_seconds(intervals) * 1e3,
                      "prepare_kernel_launches": sum(c for _, c in by_name.values()),
                      "prepare_device_ms_by_group": _by_group(by_name)}))


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
    """Device ms per call of the per-frame volume and pyramid (reg_cuda), of
    the pooled fmap2 pyramid (alt_cuda) and of the two per-iteration
    resizes, each alone at the main path's shapes."""
    import chip_smoke
    from raft_stereo_tpu_torch.corr import alt_cuda, reg_cuda
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
        "alt_pooled_pyramid": chip_smoke._device_ms(
            lambda: alt_cuda.build_alt_operands(f1, f2, num_levels=4, radius=4)),
        "resize_gru32_to_gru16": chip_smoke._device_ms(
            lambda: interp_align_corners(n32, (h // 2, w // 2))),
        "resize_gru16_to_gru08": chip_smoke._device_ms(
            lambda: interp_align_corners(n16, (h, w)))}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
