"""GV103 — no host round trips in hot-path programs.

A value the host waits for in the middle of a program serializes it: the
host stops queueing work until the card catches up, and a CUDA graph
capture of such a program fails or bakes the value in.  None of the
serving, eval or train programs has any business talking to the host
mid-program — the session's host fetches happen between programs.

Flagged, in every recorded program (ladder and probe programs included):

- ``aten._local_scalar_dense`` (``.item()``, ``float(t)``, ``bool(t)``)
  on the program's own data on its device;
- a copy of device data to the host (``.cpu()``, ``.to("cpu")``);
- an op whose output shape depends on the data (``nonzero`` and its kin,
  boolean-mask indexing): the host reads the size back;
- ``torch.cuda.synchronize``.

A program may declare a fetch site (``TraceEntry.fetches``, as
``module.py:Qualname``): the train step's one fetch of its metrics
(``engine/steps.py``) is declared there.  It is not suppressed: a
declaration names the site in the entry, where a suppression would hide a
finding.
"""

from __future__ import annotations

from typing import Iterator, Optional

from raft_stereo_tpu_torch.analysis.core import Finding
from raft_stereo_tpu_torch.analysis.trace.checkers.gv101_dtype_discipline import \
    packet
from raft_stereo_tpu_torch.analysis.trace.runner import TraceChecker, TraceContext

#: Ops whose output shape depends on the values of their input.
DATA_DEPENDENT = frozenset({
    "nonzero", "masked_select", "unique", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive", "argwhere",
})


def round_trip(op, device: str) -> Optional[str]:
    """What kind of host round trip ``op`` is, or None."""
    from raft_stereo_tpu_torch.analysis.trace.graphs import EXTERNAL
    p = packet(op.name)
    if p == "_local_scalar_dense" and op.operands:
        src = op.operands[0]
        if src.origin != EXTERNAL and src.device == device:
            return ".item() of the program's data"
    elif p == "_to_copy" and op.operands and op.outs:
        if op.operands[0].device != "cpu" and op.outs[0].device == "cpu":
            return "a copy to the host"
    elif p == "copy_" and len(op.operands) >= 2:
        if op.operands[0].device == "cpu" and op.operands[1].device != "cpu":
            return "a copy to the host"
    elif p in DATA_DEPENDENT:
        return f"{p}: a data-dependent output shape"
    elif p == "index" and any(o.dtype == "bool" for o in op.operands[1:]):
        return "boolean-mask indexing: a data-dependent output shape"
    elif p == "repeat_interleave" and op.name.endswith(".Tensor"):
        return "repeat_interleave by a tensor: a data-dependent output shape"
    return None


class HostRoundTripChecker(TraceChecker):
    code = "GV103"
    name = "host-round-trips"
    description = (".item(), a copy to the host, a data-dependent shape or "
                   "torch.cuda.synchronize in a hot-path program")

    def check(self, ctx: TraceContext) -> Iterator[Finding]:
        from raft_stereo_tpu_torch.analysis.trace.graphs import Op, Sync
        for entry in ctx.registry.all_entries():
            rec = ctx.recording(entry)
            if rec is None:
                continue
            for ev in rec.events:
                if isinstance(ev, Sync):
                    what = "torch.cuda.synchronize"
                elif isinstance(ev, Op):
                    what = round_trip(ev, rec.device)
                else:
                    continue
                if what is None or ev.site in entry.fetches:
                    continue
                yield self.finding(
                    entry.name,
                    f"host round trip in the program: {what} at "
                    f"{ev.site or 'an unknown site'} ({ev.text[:160]}) — the "
                    "host waits for the card mid-program (and a CUDA graph "
                    "capture would bake the value in); move the host work "
                    "between programs, or declare the site as the entry's "
                    "fetch")
