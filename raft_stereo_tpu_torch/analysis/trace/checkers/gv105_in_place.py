"""GV105 — the train step updates its parameters and moments in place.

The port's counterpart of the JAX package's donation check.  An AdamW step
that rebinds a parameter to a new tensor, or writes a freshly computed
full copy back into it, holds two copies of the parameters (or moments)
at the step's peak: nothing fails, training just needs more memory.

For every entry marked ``in_place`` (the train step), each tensor of the
program's state (parameters, buffers, AdamW moments) must:

- keep its storage: the same ``data_ptr`` before and after the step;
- not be written by a ``copy_``/``set_`` from a tensor produced in the
  step (a second full copy alive at that point).

A finding names the leaves that broke this.
"""

from __future__ import annotations

from typing import Iterator, List

from raft_stereo_tpu_torch.analysis.core import Finding
from raft_stereo_tpu_torch.analysis.trace.checkers.gv101_dtype_discipline import \
    packet
from raft_stereo_tpu_torch.analysis.trace.runner import TraceChecker, TraceContext


class InPlaceUpdateChecker(TraceChecker):
    code = "GV105"
    name = "in-place-update"
    description = ("train-step parameter or moment rebound or rewritten "
                   "from a second full copy")

    def check(self, ctx: TraceContext) -> Iterator[Finding]:
        from raft_stereo_tpu_torch.analysis.trace.graphs import PRODUCED, STATE
        for entry in ctx.registry.entries:
            if not entry.in_place:
                continue
            rec = ctx.recording(entry)
            if rec is None:
                continue
            before, after = rec.state_ptrs_before, rec.state_ptrs_after
            moved: List[str] = sorted(k for k in before
                                      if after.get(k) != before[k])
            copied: List[str] = []
            for op in rec.ops:
                if packet(op.name) in ("copy_", "set_") and \
                        len(op.operands) >= 2 and \
                        op.operands[0].origin == STATE and \
                        op.operands[1].origin == PRODUCED and \
                        op.operands[1].numel == op.operands[0].numel:
                    name = op.operands[0].label[len("p:"):]
                    if name not in copied:
                        copied.append(name)
            if not before:
                yield self.finding(
                    entry.name,
                    "the entry declares in-place updates but names no "
                    "state: nothing could be checked")
            bad = moved + [c for c in copied if c not in moved]
            if not bad:
                continue
            sample = ", ".join(bad[:4])
            yield self.finding(
                entry.name,
                f"{len(bad)} of {len(before)} state leaves are not updated "
                f"in place ({len(moved)} rebound to new storage, "
                f"{len(copied)} rewritten from a full copy; first: "
                f"{sample}) — the step holds a second copy of them at its "
                "peak; update with in-place ops (the foreach AdamW does)")
