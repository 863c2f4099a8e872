"""``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json``.

Prints one JSON line as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number the correctness check
compared, beside its limit), and those numbers again as the last lines of
standard error. Exits non-zero with no line when the card is missing or
fewer cards are present than the cell asks for, when the run fails, or when
JAX or the JAX package is loaded in the process.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness, spec
    bench = spec.load_benchmark()
    chips = int(spec.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"cuda available={torch.cuda.is_available()}, "
              f"devices={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                           bench=bench, whole_process=True)
    except Exception:  # noqa: BLE001 — the run's boundary: report and exit non-zero
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
