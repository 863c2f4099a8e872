#!/usr/bin/env python3
"""Device ms a frame of each kernel group inside each model range of a cell
of the port's benchmark, for one tree.

    python3 scripts/stage_groups.py --workload middlebury_f.frames --seeds 1,2 [--seconds 20] [--root ROOT]

Runs the cell once a seed as ``python3 -m portbench.stages`` does (traced,
every host thread profiled; ROOT, default this checkout, is the root of the
checkout whose port and benchmark run, such as a `git archive` of a parent
unpacked under build/), and prints one JSON line a seed: the card, the run's
frames and ``device_ms_per_frame``, and for each device-side model range of
the eager forward (``raft.encode``, ``raft.loop``, ``raft.epilogue``, and
``outside`` them) the card's busy ms a frame under it by kernel group
(``portbench/trace.py``'s groups: ``matmul`` is cuBLAS's and cuDNN's
``xmma`` kernels, ``other`` torch's own). A cell served through CUDA graphs
opens no model range; everything of it is ``outside``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _groups_by_range(device, ranges, frames: int) -> dict:
    """Busy ms a frame of each group's kernels under each model range."""
    from portbench import stages, trace
    unions = {n.split(".")[1]: trace.merged((s, e) for name, s, e, d in ranges
                                            if name == n and d)
              for n in stages.MODEL_STAGES}
    covered = trace.merged(iv for u in unions.values() for iv in u)
    out: dict = {}
    for group in sorted({trace.group_of(d[2]) for d in device}):
        events = [d for d in device if trace.group_of(d[2]) == group]
        total = sum(e - s for s, e, _ in events)
        inside = {k: stages._overlap_each(events, u) for k, u in unions.items()}
        inside["outside"] = total - stages._overlap_each(events, covered)
        for k, ns in inside.items():
            out.setdefault(k, {})[group] = ns / 1e6 / frames
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from portbench import stages
    seen: dict = {}
    table = stages.stage_table

    def stage_table(busy, device, ranges, t0, t1):
        seen.update(device=device, ranges=ranges)
        return table(busy, device, ranges, t0, t1)

    stages.stage_table = stage_table
    print(json.dumps({"device": torch.cuda.get_device_name(0), "root": args.root}), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = stages.measure(args.workload, seed, args.seconds)
        frames = rec["frames"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": rec["correct"],
                          "frames": frames,
                          "device_ms_per_frame": rec["metrics"].get("device_ms_per_frame"),
                          "groups_ms_per_frame": _groups_by_range(
                              seen["device"], seen["ranges"], frames) if frames else {}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
