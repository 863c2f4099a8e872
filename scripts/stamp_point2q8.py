#!/usr/bin/env python3
"""Where the time of the point2 q8 kernel goes, block by block.

    python3 scripts/stamp_point2q8.py [ROOT]

Copies the port of ROOT (default: this checkout) to build/stamp_point2q8/,
adds %globaltimer stamps to ``point2_q8_kernel`` in the copy's
``csrc/enc_point.cu`` (each block's start, its arrival at the grid barrier,
its release and its end), builds and runs it on chip_smoke.py's point2 q8
inputs (96x312x128 and 504x744x128, folded BatchNorm and instance norm) and
prints, a case a line, the spread of those times over the blocks in µs
from the first block's start: the phase-0 arrivals (first, median, last),
the last release, and the ends (first, median, last). The checkout's own
kernel is not changed. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
MAX_BLOCKS = 2048

STAMPS = f"""
__device__ unsigned long long g_stamp[4][{MAX_BLOCKS}];
__device__ __forceinline__ unsigned long long stamp_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}
"""
# (pattern, replacement) in the copy's point2_q8_kernel, each found once.
EDITS = (
    (r"(constexpr int kQ8Threads = \d+;)", STAMPS + r"\1"),
    (r"(  uint4\* kept = reinterpret_cast<uint4\*>\(sm \+ \(NORM \? 2 \* C : 0\)\);\n)",
     r"\1  if (threadIdx.x == 0) g_stamp[0][blockIdx.x] = stamp_now();\n"),
    (r"(  if \(tid == 0\) \{\n)(    for \(int w = 1; w < T / 32; \+\+w\))",
     r"\1    g_stamp[1][blockIdx.x] = stamp_now();\n\2"),
    (r"(\n)(    amax_bits = \*reinterpret_cast)",
     r"\1    g_stamp[2][blockIdx.x] = stamp_now();\n\2"),
    (r"(q8\[i\] = quant8x8\(kept\[j \* T \+ tid\], s, rcp\);\n  \}\n)",
     r"\1  __syncthreads();\n  if (threadIdx.x == 0) g_stamp[3][blockIdx.x] = stamp_now();\n"),
)
READER = """
extern "C" int rst_point2_q8_stamps(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, rst::g_stamp, sizeof(rst::g_stamp));
}
"""


def stamped_copy(root: Path) -> Path:
    dst = HERE / "build" / "stamp_point2q8"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "raft_stereo_tpu_torch", dst / "raft_stereo_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = dst / "raft_stereo_tpu_torch" / "csrc" / "enc_point.cu"
    text = src.read_text()
    for pattern, repl in EDITS:
        text, n = re.subn(pattern, repl, text, count=1)
        if n != 1:
            raise SystemExit(f"stamp_point2q8: no place for a stamp: {pattern}")
    src.write_text(text + READER)
    return dst


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()
    import torch
    if not torch.cuda.is_available():
        print("stamp_point2q8: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np
    sys.path.insert(0, str(stamped_copy(root)))
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.ops import encoder as enc
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), "tree", root)
    kernels.build(["enc_point"])
    read = ctypes.CDLL(str(kernels.library_path("enc_point"))).rst_point2_q8_stamps
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    for h, w in (cs.FEAT, cs.ALT_HEADLINE_FEAT):
        g = cs._gen(29)
        shape = (1, h, w, 128)
        x, y = cs._randn(shape, g), cs._enc_triple(g, shape, True)
        for norm in (False, True):
            for _ in range(3):  # the last call's stamps are read
                enc.point2(x, y, norm=norm, quant=True)
            torch.cuda.synchronize()
            stamps = np.zeros((4, MAX_BLOCKS), np.uint64)
            kernels.check("rst_point2_q8_stamps",
                          read(stamps.ctypes.data_as(ctypes.c_void_p)))
            blocks = int((stamps[0] > 0).sum())
            t = stamps[:, :blocks].astype(np.int64)
            us = (t - t[0].min()) / 1e3
            print(json.dumps({
                "shape": f"{h}x{w}x128", "norm": "in" if norm else "bn", "blocks": blocks,
                "arrive_us": [float(us[1].min()), float(np.median(us[1])), float(us[1].max())],
                "release_us": float(us[2].max()),
                "end_us": [float(us[3].min()), float(np.median(us[3])), float(us[3].max())]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
