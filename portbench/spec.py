"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix, and each metric. Everything else is a file of
its own under this package, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the architecture as it is run;
- ``traffic/<mix>.json``: a ``driver`` name and its parameters;
- ``drivers/<driver>.py``: the code that drives the port with a mix;
- ``metrics/<metric>.py``: a ``read(rec)`` for each metric, end-to-end and
  per-layer alike;
- ``limits/<cell>.json``: each number the correctness check compares in
  that cell, with its limit.

A new configuration, mix, driver, metric or cell is new files and new
entries; no file here names them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
BENCHMARK = PACKAGE.parent / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Optional[Path] = None) -> dict:
    return _json(path or BENCHMARK)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(PACKAGE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(PACKAGE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict[str, float]:
    return _json(PACKAGE / "limits" / f"{cell_name}.json")


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py`` (loaded by path, so a
    metric's name may hold dots)."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: with ``trace`` the per-layer
    ones, else the end-to-end ones; each where its ``workloads`` list, if it
    has one, names the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", (cell_name,))]
