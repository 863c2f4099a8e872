"""Program ledger: cost and memory accounting per program.

The port's counterpart of the JAX package's ``obs/ledger.py``, with its
names and dump schema: one :class:`LedgerRow` per program key, the chip
peak tables, the per-kind MFU join (:meth:`ProgramLedger.attribution`) and
the ``report`` CLI.

Where the numbers come from (:func:`analyze_program`):

- **flops** are counted by ``torch.utils.flop_counter.FlopCounterMode``
  over the aten operations a call dispatches. The hand-written CUDA kernels
  are opaque to it (as Pallas calls are to XLA's cost analysis), so a
  caller counts the program's plain twin instead (``twin``): the bench
  counts the fp32 ``reg`` forward on the meta device, which allocates
  nothing. The Python refinement loop runs every iteration, so the count is
  the whole program's at its iterations: rows carry ``scan_scale=1``.
  The counter counts convolutions and matrix products; XLA also counts
  elementwise operations.
- **bytes_accessed** stays ``None``: without a hardware counter there is
  no honest count of the bytes a program moves, so the roofline class is
  reported absent, never guessed.
- **memory** comes from the CUDA caching allocator around one call on the
  card (``memory_allocated`` before and after, ``max_memory_allocated``
  during): ``argument_bytes`` what was allocated at the call's start,
  ``output_bytes`` what the call left allocated, ``temp_bytes`` the rest of
  its peak, so that ``peak_hbm_bytes`` is the call's peak. ``None`` on the
  CPU and on the meta device.

A serving session's program (``serve/session.py``) is a CUDA graph on the
card. Its row (:func:`program_twin` for the flops) takes its memory from the
caching allocator over the program's warm-up and capture: ``argument_bytes``
its static inputs, ``temp_bytes`` the rest of the peak
(``max_memory_allocated``), and, apart, ``graph_pool_bytes`` (what the
graph's private pool reserved) and ``capture_s`` (the capture's seconds, in
the place of the JAX package's compile). On the CPU a session's programs run
eagerly and have no memory numbers.

MFU is absent wherever an input is missing: a device not in the peak
table (the CPU) has no peaks, and its MFU is never computed against a
made-up one.

CLI::

    python -m raft_stereo_tpu_torch.obs.ledger report LEDGER.json [--json]

exits 0 when every cached program has a ledger row, 1 when the dump
reports missing rows, 2 on a malformed file (never silently clean).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

SCHEMA = 1

# -- chip peak tables ---------------------------------------------------------

#: Peak dense bf16 FLOP/s by device kind (the MFU denominator), from
#: NVIDIA's H100 data sheet (tensor cores, without sparsity). Matched by
#: substring of ``torch.cuda.get_device_name()``. The PCIe card has its own
#: row so that it never takes the SXM part's peaks.
PEAK_FLOPS: Dict[str, float] = {
    "H100 80GB HBM3": 989e12, "H100 SXM": 989e12, "H100 PCIe": 756e12,
}

#: Peak HBM bandwidth, bytes/s: the roofline's other axis.
PEAK_HBM_BW: Dict[str, float] = {
    "H100 80GB HBM3": 3.35e12, "H100 SXM": 3.35e12, "H100 PCIe": 2.0e12,
}

#: HBM capacity, bytes.
HBM_BYTES: Dict[str, float] = {
    "H100 80GB HBM3": 80 * 2**30, "H100 SXM": 80 * 2**30, "H100 PCIe": 80 * 2**30,
}


def chip_peaks(device_kind: Optional[str]) -> Optional[Tuple[float, float]]:
    """(peak_flops_per_s, peak_hbm_bytes_per_s) for a device kind, or
    ``None`` when it is not in the table (the CPU): its MFU is then absent,
    never computed against a made-up peak."""
    if not device_kind:
        return None
    for k, f in PEAK_FLOPS.items():
        if k in device_kind:
            return f, PEAK_HBM_BW[k]
    return None


def hbm_capacity(device_kind: Optional[str]) -> Optional[float]:
    if not device_kind:
        return None
    for k, v in HBM_BYTES.items():
        if k in device_kind:
            return v
    return None


# -- program analysis -----------------------------------------------------------

_FIELDS = ("flops", "bytes_accessed", "argument_bytes", "output_bytes", "temp_bytes",
           "alias_bytes", "generated_code_bytes")


def count_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """The flops ``FlopCounterMode`` counts in one call of ``fn``; ``None``
    when it counts none."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


def _device(args):
    import torch
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, torch.nn.Module):
            for p in a.parameters():
                return p.device
    return None


def analyze_program(fn: Callable, *args, twin: Optional[Callable[[], object]] = None
                    ) -> Dict[str, Optional[float]]:
    """Run ``fn(*args)`` once and account for it: {flops, bytes_accessed,
    argument/output/temp/alias/generated_code bytes}, each ``None`` where it
    cannot be had (module docstring). ``flops`` is the count of ``twin()``
    where given (the plain twin of a program whose kernels the counter cannot
    see), else of this call."""
    import torch
    out: Dict[str, Optional[float]] = dict.fromkeys(_FIELDS)
    dev = _device(args)
    on_card = dev is not None and dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
    if twin is None:
        out["flops"] = count_flops(fn, *args)
    else:
        fn(*args)
    if on_card:
        torch.cuda.synchronize(dev)
        left = max(torch.cuda.memory_allocated(dev) - start, 0)
        peak = torch.cuda.max_memory_allocated(dev)
        out.update(argument_bytes=float(start), output_bytes=float(left),
                   temp_bytes=float(max(peak - start - left, 0)))
    if twin is not None:
        out["flops"] = count_flops(twin)
    return out


def program_twin(kind: str, cfg, b: int, h: int, w: int, iters: int
                 ) -> Callable[[], object]:
    """A serving program's plain twin on the meta device, which allocates
    nothing: the fp32 ``reg`` model at ``cfg``'s architecture, running the
    serving program ``kind`` (``serve/session.py:PROGRAM_KINDS``) at batch
    ``b`` and padded size ``h`` x ``w``. The carry a segment, advance or
    epilogue program takes is made outside the returned callable, so only
    the program's own operations are counted."""
    import torch

    from raft_stereo_tpu_torch.models import (
        RAFTStereo, raft_stereo_epilogue, raft_stereo_forward, raft_stereo_prepare,
        raft_stereo_segment, raft_stereo_segment_carry)
    twin_cfg = dataclasses.replace(cfg, corr_implementation="reg", mixed_precision=False)
    with torch.device("meta"):
        model = RAFTStereo(twin_cfg).eval()
        image = torch.zeros((b, h, w, 3))
        f = twin_cfg.downsample_factor
        flow = torch.zeros((b, h // f, w // f, 2))
        state = (raft_stereo_prepare(model, image, image)
                 if kind in ("segment", "advance", "epilogue") else None)
    programs = {
        "full": lambda: raft_stereo_forward(model, image, image, iters=iters),
        "prepare": lambda: raft_stereo_prepare(model, image, image),
        "prepare_warm": lambda: raft_stereo_prepare(model, image, image, flow_init=flow),
        "segment": lambda: raft_stereo_segment(model, state, iters=iters),
        "advance": lambda: raft_stereo_segment_carry(model, state, iters=iters),
        "epilogue": lambda: raft_stereo_epilogue(model, state),
    }
    if kind not in programs:
        raise ValueError(f"unknown program kind {kind!r}")
    fn = programs[kind]

    def run():
        with torch.device("meta"):
            return fn()
    return run


def ledger_id(key) -> str:
    """Short stable display id for a program key:
    ``kind@b<b>:<h>x<w>/it<iters>`` for a 6-tuple key, plus an 8-hex-char
    hash of the full key, so two configurations of one geometry get
    distinct rows."""
    digest = hashlib.sha1(repr(key).encode()).hexdigest()[:8]
    if (isinstance(key, tuple) and len(key) == 6
            and isinstance(key[0], str)):
        kind, b, h, w, iters, _fp = key
        return f"{kind}@b{b}:{h}x{w}/it{iters}#{digest}"
    head = key[0] if isinstance(key, tuple) and key else key
    return f"{head}#{digest}"


# -- the ledger ---------------------------------------------------------------

@dataclasses.dataclass
class LedgerRow:
    """One program's account (:func:`analyze_program`). ``flops_est`` /
    ``bytes_est`` are ``flops`` / ``bytes_accessed`` times ``scan_scale``,
    the per-invocation estimates (the port counts whole programs:
    ``scan_scale=1``), ``None`` without a scale."""

    id: str
    kind: str
    b: int = 1
    h: Optional[int] = None
    w: Optional[int] = None
    iters: int = 0
    scan_scale: Optional[int] = None
    backend: Optional[str] = None
    device_kind: Optional[str] = None
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[float] = None
    output_bytes: Optional[float] = None
    temp_bytes: Optional[float] = None
    alias_bytes: Optional[float] = None
    generated_code_bytes: Optional[float] = None
    flops_est: Optional[float] = None
    bytes_est: Optional[float] = None
    capture_s: Optional[float] = None
    graph_pool_bytes: Optional[float] = None

    @property
    def peak_hbm_bytes(self) -> Optional[float]:
        """Device-memory footprint while the program runs: arguments +
        outputs + temporaries minus aliased buffers. ``None`` when no
        memory was measured (the CPU, the meta device): absent, not zero."""
        parts = [self.argument_bytes, self.output_bytes, self.temp_bytes]
        if all(p is None for p in parts):
            return None
        total = sum(p for p in parts if p is not None)
        return total - (self.alias_bytes or 0.0)

    def intensity(self) -> Optional[float]:
        """Arithmetic intensity flop/byte; ``None`` without both counts."""
        if self.flops and self.bytes_accessed:
            return self.flops / self.bytes_accessed
        return None

    def roofline(self, peaks: Optional[Tuple[float, float]]
                 ) -> Optional[str]:
        """'compute-bound' / 'hbm-bound' against the chip ridge point;
        ``None`` off the table (CPU) or without both counts."""
        inten = self.intensity()
        if peaks is None or inten is None:
            return None
        ridge = peaks[0] / peaks[1]
        return "compute-bound" if inten >= ridge else "hbm-bound"

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["peak_hbm_bytes"] = self.peak_hbm_bytes
        d["intensity"] = self.intensity()
        d["roofline"] = self.roofline(chip_peaks(self.device_kind))
        return d


def _derive_estimates(row: LedgerRow) -> None:
    if row.scan_scale is not None:
        if row.flops is not None:
            row.flops_est = row.flops * row.scan_scale
        if row.bytes_accessed is not None:
            row.bytes_est = row.bytes_accessed * row.scan_scale


class ProgramLedger:
    """Thread-safe map from the exact program key to its
    :class:`LedgerRow`; readers see a consistent snapshot."""

    def __init__(self):
        self._rows: Dict[object, LedgerRow] = {}
        self._lock = threading.Lock()

    def record(self, key, *, kind: str, b: int = 1,
               h: Optional[int] = None, w: Optional[int] = None,
               iters: int = 0, scan_scale: Optional[int] = None,
               analysis: Optional[Dict[str, Optional[float]]] = None,
               backend: Optional[str] = None,
               device_kind: Optional[str] = None) -> LedgerRow:
        row = LedgerRow(id=ledger_id(key), kind=kind, b=b, h=h, w=w,
                        iters=iters, scan_scale=scan_scale,
                        backend=backend, device_kind=device_kind)
        for field, value in (analysis or {}).items():
            if field in LedgerRow.__dataclass_fields__:
                setattr(row, field, value)
        _derive_estimates(row)
        with self._lock:
            self._rows[key] = row
        return row

    def annotate(self, key, **fields) -> Optional[LedgerRow]:
        """Attach out-of-band estimates to an existing row. Unknown keys
        are a no-op returning None: annotation is advisory telemetry."""
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                return None
            for f, v in fields.items():
                if f in LedgerRow.__dataclass_fields__:
                    setattr(row, f, v)
            return row

    def drop(self, key) -> Optional[LedgerRow]:
        with self._lock:
            return self._rows.pop(key, None)

    def row(self, key) -> Optional[LedgerRow]:
        with self._lock:
            return self._rows.get(key)

    def rows(self) -> List[LedgerRow]:
        with self._lock:
            return list(self._rows.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def rows_by_id(self, ids: Iterable[str]) -> List[Dict]:
        wanted = set(ids)
        return [r.to_dict() for r in self.rows() if r.id in wanted]

    # -- the MFU join ------------------------------------------------------

    def attribution(self, registry, *, device_kind: Optional[str] = None,
                    peaks: Optional[Tuple[float, float]] = None) -> Dict:
        """Per-program-kind MFU/roofline: join the registry's
        ``raft_program_flops_total`` / ``raft_program_hbm_bytes_total``
        counters with its ``raft_program_device_seconds_total`` and the
        chip peak table. Every output is ``None`` unless all of its inputs
        exist and are positive: zero device seconds, a device off the
        table (CPU) or absent flops give an absent MFU, never a division."""
        if peaks is None:
            peaks = chip_peaks(device_kind)
        kinds = {r.kind for r in self.rows()}
        kinds |= {labels.get("kind") for labels, _ in
                  registry.series("raft_program_device_seconds_total")}
        out: Dict[str, Dict] = {}
        for kind in sorted(k for k in kinds if k):
            flops = registry.value("raft_program_flops_total", kind=kind)
            hbm = registry.value("raft_program_hbm_bytes_total", kind=kind)
            secs = registry.value("raft_program_device_seconds_total",
                                  kind=kind)
            calls = registry.value("raft_program_calls_total", kind=kind)
            mfu = (flops / secs / peaks[0]
                   if peaks and flops > 0 and secs > 0 else None)
            bw_util = (hbm / secs / peaks[1]
                       if peaks and hbm > 0 and secs > 0 else None)
            roofline = None
            if peaks and flops > 0 and hbm > 0:
                roofline = ("compute-bound"
                            if flops / hbm >= peaks[0] / peaks[1]
                            else "hbm-bound")
            out[kind] = {"calls": calls, "device_seconds": secs,
                         "flops": flops or None, "hbm_bytes": hbm or None,
                         "mfu": mfu, "hbm_bw_util": bw_util,
                         "roofline": roofline}
        return out

    # -- dumps -------------------------------------------------------------

    def to_doc(self, *, cache_keys: Iterable = (),
               backend: Optional[str] = None,
               device_kind: Optional[str] = None,
               attribution: Optional[Dict] = None,
               cache_hbm: Optional[Dict] = None) -> Dict:
        """JSON-able dump and the completeness verdict: every live cache
        key must have a ledger row."""
        cache_ids = [ledger_id(k) for k in cache_keys]
        with self._lock:
            have = {ledger_id(k) for k in self._rows}
            rows = [r.to_dict() for r in self._rows.values()]
        missing = sorted(i for i in cache_ids if i not in have)
        return {"schema": SCHEMA, "backend": backend,
                "device_kind": device_kind,
                "hbm_capacity_bytes": hbm_capacity(device_kind),
                "rows": rows, "cache": cache_ids, "missing": missing,
                "complete": not missing,
                "attribution": attribution or {},
                "cache_hbm": cache_hbm or {}}


def dump_path() -> Optional[str]:
    """The ``RAFT_LEDGER`` dump target (read at call time), where a
    caller writes its ledger doc for the ``report`` step."""
    return os.environ.get("RAFT_LEDGER") or None


def save_doc(doc: Dict, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


# -- CLI ----------------------------------------------------------------------

def _fmt_num(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if abs(v) >= 1e12:
        return f"{v / 1e12:.2f}T"
    if abs(v) >= 1e9:
        return f"{v / 1e9:.2f}G"
    if abs(v) >= 1e6:
        return f"{v / 1e6:.2f}M"
    return f"{v:.4g}"


def _fmt_bytes(v: Optional[float]) -> str:
    return "-" if v is None else f"{v / 2**20:.1f}MiB"


def load_doc(path: str) -> Dict:
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise ValueError(f"cannot read {path}: {e}") from e
    except ValueError as e:
        raise ValueError(f"{path} is not valid JSON: {e}") from e
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA or \
            not isinstance(doc.get("rows"), list):
        raise ValueError(
            f"{path} is not a schema-{SCHEMA} ledger dump "
            "({'schema': 1, 'rows': [...]})")
    # Element-level validation: a truncated/corrupted dump whose rows are
    # not id-carrying dicts must be exit 2 (malformed), not a misleading
    # exit-1 completeness failure with a traceback.
    for r in doc["rows"]:
        if not isinstance(r, dict) or not isinstance(r.get("id"), str):
            raise ValueError(
                f"{path}: malformed ledger row {r!r} (rows must be "
                "dicts carrying a string 'id')")
    return doc


def _cmd_report(args) -> int:
    doc = load_doc(args.ledger)
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        print(f"ledger: {len(doc['rows'])} row(s), backend="
              f"{doc.get('backend')}, device={doc.get('device_kind')}")
        hdr = (f"{'program':<34} {'flops':>8} {'flops_est':>9} "
               f"{'bytes':>8} {'peak_hbm':>10} {'roofline':>13}")
        print(hdr)
        for r in sorted(doc["rows"], key=lambda r: r["id"]):
            print(f"{r['id']:<34} {_fmt_num(r.get('flops')):>8} "
                  f"{_fmt_num(r.get('flops_est')):>9} "
                  f"{_fmt_num(r.get('bytes_accessed')):>8} "
                  f"{_fmt_bytes(r.get('peak_hbm_bytes')):>10} "
                  f"{(r.get('roofline') or '-'):>13}")
        for kind, a in sorted((doc.get("attribution") or {}).items()):
            mfu = a.get("mfu")
            print(f"mfu[{kind}]: "
                  f"{f'{mfu:.2%}' if mfu is not None else 'absent'} "
                  f"({a.get('calls', 0):.0f} calls, "
                  f"{a.get('device_seconds', 0):.3f} device-s, "
                  f"{a.get('roofline') or 'roofline unknown'})")
        ch = doc.get("cache_hbm") or {}
        for bucket, v in sorted((ch.get("by_bucket") or {}).items()):
            print(f"cache_hbm[{bucket}]: {_fmt_bytes(v)}")
        if ch.get("total_bytes") is not None:
            cap = doc.get("hbm_capacity_bytes")
            of = f" of {_fmt_bytes(cap)}" if cap else ""
            print(f"cache_hbm[total]: {_fmt_bytes(ch['total_bytes'])}{of}")
    if doc.get("missing"):
        for m in doc["missing"]:
            print(f"FAIL: cached program {m} has no ledger row", flush=True)
        return 1
    print(f"ledger: complete ({len(doc.get('cache', []))} cached "
          "program(s) all have rows)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_stereo_tpu_torch.obs.ledger",
        description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("report", help="print a ledger dump; exit 1 when "
                       "any cached program lacks a row")
    r.add_argument("ledger")
    r.add_argument("--json", action="store_true")
    r.set_defaults(func=_cmd_report)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except (ValueError, KeyError, TypeError) as e:
        # Malformed input can never read as a (mis)classified verdict.
        print(f"ledger: internal error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
