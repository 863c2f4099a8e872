"""The perf trajectory: one file of headline metrics, and a band per metric.

A copy of the JAX package's jax-free ``obs/trajectory.py`` (same schema,
same CLI), so the port imports nothing of that package.

- a bench **emits** its headline metric into one ``TRAJECTORY.json`` when
  ``RAFT_TRAJECTORY=/path`` is set (:func:`emit`; unset, nothing is
  written);
- a bands file pins a band per metric: ``{"value": <pinned>,
  "rel_band": 0.2}`` means the metric may not fall below
  ``pinned * (1 - rel_band)``; an explicit ``"min"`` overrides the derived
  floor. A value above ``pinned * (1 + rel_band)`` is a note (re-pin the
  improvement), never a failure;
- ``check`` fails (exit 1) when any emitted entry with a band is below its
  floor;
- an existing band moves only by an explicit re-pin; a missing band is
  recorded only under ``--autopin``, which never overwrites and skips
  backend-namespaced keys.

Metric keys are namespaced by backend (:func:`metric_key`): the port's
bench emits ``cuda:...`` on the card and ``cpu:...`` on the CPU, so no band
pinned for a TPU metric in ``trajectory_bands.json`` can judge them.

CLI::

    python -m raft_stereo_tpu_torch.obs.trajectory check TRAJECTORY.json \
        --bands BANDS.json [--autopin]
    python -m raft_stereo_tpu_torch.obs.trajectory show TRAJECTORY.json

Exit codes: 0 in band, 1 out of band, 2 a malformed file (never "clean").
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

SCHEMA = 1

#: Default regression band: 20% below the pinned value fails. Wide enough
#: for run-to-run jitter on a dedicated chip, tight enough that a dead fast
#: path (2x and more) cannot hide.
DEFAULT_REL_BAND = 0.20


class TrajectoryError(ValueError):
    """Malformed trajectory/bands file — the CLI maps this to exit 2."""


def metric_key(metric: str, backend: Optional[str] = None) -> str:
    """Backend-namespaced metric key: bare on TPU (the JAX package's
    bands), ``<backend>:``-prefixed elsewhere (``cuda:``, ``cpu:``)."""
    if backend is None or backend == "tpu":
        return metric
    return f"{backend}:{metric}"


def _empty() -> Dict:
    return {"schema": SCHEMA, "entries": []}


def load(path: str) -> Dict:
    """Load a trajectory file; a missing file is an empty trajectory, a
    present-but-malformed one is an error (never silently reset)."""
    if not os.path.exists(path):
        return _empty()
    try:
        with open(path) as f:
            doc = json.load(f)
    except ValueError as e:
        raise TrajectoryError(f"{path} is not valid JSON: {e}") from e
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA or \
            not isinstance(doc.get("entries"), list):
        raise TrajectoryError(
            f"{path} is not a schema-{SCHEMA} trajectory "
            "({'schema': 1, 'entries': [...]})")
    return doc


def _atomic_write(path: str, doc: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def emit(metric: str, value: float, unit: str, *,
         backend: Optional[str] = None, source: Optional[str] = None,
         extra: Optional[Dict] = None,
         path: Optional[str] = None) -> Optional[Dict]:
    """Append one trajectory entry to ``path`` (default: the
    ``RAFT_TRAJECTORY`` env target; unset -> no-op, returns None) and
    return the entry written.  Benches call this right after printing
    their JSON line; outside a gate run it costs one env read."""
    if path is None:
        path = os.environ.get("RAFT_TRAJECTORY") or None
    if not path:
        return None
    doc = load(path)
    entry: Dict = {"metric": metric_key(metric, backend),
                   "value": float(value), "unit": unit}
    if backend is not None:
        entry["backend"] = backend
    if source is not None:
        entry["source"] = source
    if extra:
        entry["extra"] = extra
    doc["entries"].append(entry)
    _atomic_write(path, doc)
    return entry


# -- bands ------------------------------------------------------------------

def load_bands(path: str) -> Dict:
    if not os.path.exists(path):
        return {"schema": SCHEMA, "bands": {}}
    try:
        with open(path) as f:
            doc = json.load(f)
    except ValueError as e:
        raise TrajectoryError(f"{path} is not valid JSON: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("bands"), dict):
        raise TrajectoryError(
            f"{path} is not a bands file ({{'schema': 1, 'bands': ...}})")
    return doc


def band_floor(band: Dict) -> float:
    """The failure threshold of one band: explicit ``min`` wins, else
    ``value * (1 - rel_band)``. A band with neither is malformed."""
    if "min" in band:
        return float(band["min"])
    if "value" not in band:
        raise TrajectoryError(
            f"band {band!r} has neither 'value' nor 'min' — no floor can "
            "be derived")
    return float(band["value"]) * (1.0 - float(
        band.get("rel_band", DEFAULT_REL_BAND)))


#: Extra keys autopin copies from an entry into its band: the device
#: ledger's diagnostic account (obs/ledger.py). On a
#: later out-of-band failure these pins let ``check`` say WHY: flops
#: changed => the compiled program itself changed; flops same but the
#: metric fell => same program, slower wall clock (machine/env drift).
DIAGNOSTIC_EXTRAS = ("flops", "bytes", "mfu")

#: Relative flops drift below which the program counts as "unchanged"
#: for the diagnosis (compiler reassociation jitter, not a regression).
FLOPS_DRIFT_RTOL = 0.02


def _diagnose(entry: Dict, band: Dict) -> str:
    """One-line failure attribution from the ledger extras (always
    produced — absence of telemetry is itself stated, never silent)."""
    e = entry.get("extra") or {}
    b = band.get("extra") or {}
    ef, bf = e.get("flops"), b.get("flops")
    if isinstance(ef, (int, float)) and isinstance(bf, (int, float)) and bf:
        drift = (ef - bf) / abs(bf)
        if abs(drift) > FLOPS_DRIFT_RTOL:
            return (f"diagnosis: program flops changed "
                    f"{bf:.4g} -> {ef:.4g} ({drift:+.1%}) — the compiled "
                    "program itself changed; suspect a model/lowering "
                    "regression, not the machine")
        return ("diagnosis: flops unchanged but the metric fell — same "
                "program, slower wall clock; suspect machine/env drift "
                "(backend flags, contention, thermal)")
    return ("diagnosis: no pinned flops extra for this metric — emit the "
            "device-ledger extras (obs/ledger.py) and re-pin to enable "
            "program-vs-machine attribution")


@dataclasses.dataclass
class CheckResult:
    failures: List[str]
    notes: List[str]
    unpinned: List[str]
    checked: int = 0

    @property
    def ok(self) -> bool:
        return not self.failures


def check(doc: Dict, bands_doc: Dict) -> CheckResult:
    """Every emitted entry with a pinned band must sit above its floor."""
    bands = bands_doc.get("bands", {})
    res = CheckResult([], [], [])
    for entry in doc.get("entries", []):
        metric = entry.get("metric")
        value = entry.get("value")
        if not isinstance(metric, str) or not isinstance(value, (int, float)):
            raise TrajectoryError(f"malformed trajectory entry: {entry!r}")
        band = bands.get(metric)
        if band is None:
            res.unpinned.append(metric)
            continue
        res.checked += 1
        floor = band_floor(band)
        # A min-only band (explicit floor, no pinned center) is legal:
        # it gates the downside and opts out of the upward re-pin note.
        pinned = band.get("value")
        if value < floor:
            ref = (f"pinned {float(pinned):.4f}, band "
                   f"{band.get('rel_band', DEFAULT_REL_BAND):.0%}"
                   if pinned is not None else "explicit min")
            res.failures.append(
                f"{metric}: {value:.4f} {entry.get('unit', '')} is below "
                f"the pinned floor {floor:.4f} ({ref}) — a perf "
                "regression; if intentional, re-pin trajectory_bands.json "
                "explicitly | " + _diagnose(entry, band))
        elif pinned is not None and value > float(pinned) * (1.0 + float(
                band.get("rel_band", DEFAULT_REL_BAND))):
            res.notes.append(
                f"{metric}: {value:.4f} exceeds the pinned band upward "
                f"(pinned {float(pinned):.4f}) — re-pin to lock in the "
                "improvement")
    return res


def autopin(doc: Dict, bands_doc: Dict,
            rel_band: float = DEFAULT_REL_BAND) -> List[str]:
    """Record a band for every UNPINNED entry (never moves an existing
    one — recording is the only way a band is born, re-pinning is a
    deliberate edit).  Returns the metrics pinned.  CPU-namespaced keys
    are skipped: a shared-runner CPU number is machine noise, not a
    floor worth enforcing."""
    bands = bands_doc.setdefault("bands", {})
    pinned: List[str] = []
    for entry in doc.get("entries", []):
        metric = entry["metric"]
        if metric in bands or ":" in metric:
            continue
        bands[metric] = {"value": float(entry["value"]),
                         "rel_band": rel_band,
                         "unit": entry.get("unit", "")}
        # Pin the device-ledger diagnostics alongside the value: a later
        # out-of-band failure can then attribute itself (program flops
        # changed vs machine drift) instead of just failing.
        extras = {k: (entry.get("extra") or {}).get(k)
                  for k in DIAGNOSTIC_EXTRAS
                  if isinstance((entry.get("extra") or {}).get(k),
                                (int, float))}
        if extras:
            bands[metric]["extra"] = extras
        pinned.append(metric)
    return pinned


# -- CLI --------------------------------------------------------------------

def _cmd_check(args) -> int:
    doc = load(args.trajectory)
    bands_doc = load_bands(args.bands)
    if args.autopin:
        newly = autopin(doc, bands_doc, rel_band=args.rel_band)
        if newly:
            _atomic_write(args.bands, bands_doc)
            for m in newly:
                print(f"trajectory: PINNED (new metric) {m} = "
                      f"{bands_doc['bands'][m]['value']:.4f} "
                      f"(band {args.rel_band:.0%}) — now enforced",
                      file=sys.stderr)
    if not bands_doc.get("bands"):
        # The gate passes vacuously with an empty bands file. Say so
        # loudly instead of printing a clean-looking "0 out of band": a
        # gate that checks nothing must not read like one that checked
        # everything.
        print("trajectory: WARNING: 0 bands pinned — gate is vacuous "
              "until the first on-chip --autopin")
    res = check(doc, bands_doc)
    for n in res.notes:
        print(f"note: {n}", file=sys.stderr)
    for m in sorted(set(res.unpinned)):
        print(f"unpinned: {m} (no band; --autopin records one for a "
              "metric without a backend prefix)", file=sys.stderr)
    for f in res.failures:
        print(f"FAIL: {f}")
    print(f"trajectory: {len(doc['entries'])} entr"
          f"{'y' if len(doc['entries']) == 1 else 'ies'}, "
          f"{res.checked} checked against bands, "
          f"{len(res.failures)} out of band")
    return 1 if res.failures else 0


def _cmd_show(args) -> int:
    doc = load(args.trajectory)
    for e in doc["entries"]:
        src = f"  [{e['source']}]" if e.get("source") else ""
        print(f"{e['metric']}: {e['value']} {e.get('unit', '')}{src}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_stereo_tpu_torch.obs.trajectory",
        description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="gate a trajectory against bands")
    c.add_argument("trajectory")
    c.add_argument("--bands", required=True)
    c.add_argument("--autopin", action="store_true",
                   help="record bands for unpinned non-namespaced metrics "
                        "(never overwrites)")
    c.add_argument("--rel-band", type=float, default=DEFAULT_REL_BAND)
    c.set_defaults(func=_cmd_check)
    s = sub.add_parser("show", help="print a trajectory")
    s.add_argument("trajectory")
    s.set_defaults(func=_cmd_show)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except TrajectoryError as e:
        print(f"trajectory: internal error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
