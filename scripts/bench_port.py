#!/usr/bin/env python3
"""Run the port's bench (``python -m raft_stereo_tpu_torch.bench``) over its
configurations on one card, each in its own process, and print the card's
name and power limit and then each run's JSON line with its name.

    python3 scripts/bench_port.py [NAME ...]

Configurations (``CELLS``): ``headline`` (Middlebury-F 2016x2976, the
default model, 32 iterations), ``kitti`` (the default model at 384x1248),
``kitti_slow_fast`` (the same with ``slow_fast_gru``), ``realtime`` (the
reference's realtime model at 384x1248, 7 iterations). A run that fails
stops the script with its output.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KITTI = {"RAFT_BENCH_H": "384", "RAFT_BENCH_W": "1248"}
CELLS = {
    "headline": {},
    "kitti": KITTI,
    "kitti_slow_fast": {**KITTI, "RAFT_BENCH_SLOW_FAST": "1"},
    "realtime": {**KITTI, "RAFT_BENCH_ITERS": "7", "RAFT_BENCH_SHARED": "1",
                 "RAFT_BENCH_DOWNSAMPLE": "3", "RAFT_BENCH_GRU_LAYERS": "2",
                 "RAFT_BENCH_SLOW_FAST": "1"},
}


def main(names) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0]}))
    for name in names or CELLS:
        env = {k: v for k, v in os.environ.items() if not k.startswith("RAFT_BENCH_")}
        env.update(CELLS[name], PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "raft_stereo_tpu_torch.bench"], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=900)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
        if proc.returncode != 0 or len(lines) != 1:
            print(proc.stdout[-3000:], proc.stderr[-6000:], sep="\n", file=sys.stderr)
            return 1
        print(json.dumps({"cell": name, "env": CELLS[name],
                          "seconds": time.perf_counter() - t0, **json.loads(lines[0])}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
