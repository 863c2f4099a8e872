"""The study the correctness limits are set from (not part of a run).

``python -m portbench.study --workload <cell> --seeds <n,n,...> --seconds <s>
[--control]`` runs the cell once for each seed in one process, as
``portbench.run`` does, and prints one JSON line a seed: every number of
the check (``judge.numbers``) for the port's sampled answers and, with
``--control``, for the control's answers of the same pairs (the reference
one precision below, ``reference/fp8.py``), both against the float32
reference. Run under ``RAFT_LANE_PACK8=1 RAFT_CORR_PACK8=1`` it reads the
port's own int8 paths instead.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from portbench import harness, judge


def control_values(keep: dict, device) -> dict:
    model = judge.reference_model(keep["arch"], keep["weights"], device, lower=True)
    pool = keep["pool"]
    idx = [i for i, _ in keep["answers"]]
    got = judge.reference_disparities(model, lambda i: pool[i], idx, keep["iters"])
    return judge.numbers([(i, got[i]) for i in idx], keep["refs"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        keep: dict = {}
        t0 = time.perf_counter()
        line = harness.run(args.workload, seed, args.seconds, False, keep=keep)
        out = {"workload": args.workload, "seed": seed, "correct": line["correct"],
               "attempted": line["attempted"], "failed": line["failed"],
               "answers": len(keep["answers"]),
               "pairs": len({i for i, _ in keep["answers"]}),
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "program": keep["values"]}
        if args.control:
            t1 = time.perf_counter()
            out["control"] = control_values(keep, torch.device("cuda"))
            out["control_s"] = time.perf_counter() - t1
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del keep, line
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
