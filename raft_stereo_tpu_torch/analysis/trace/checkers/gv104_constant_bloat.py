"""GV104 — no large tensor held from outside the program.

A tensor a program reads that is neither its input, nor a parameter,
buffer or optimizer state of the model, nor produced inside the program,
is held by a closure or a cache: a captured CUDA graph then keeps reading
that memory (a stale value after the holder changes it), and every
captured program of the cache's shape x batch x fingerprint grid may hold
its own.  The right form is an input, a parameter or buffer, or a tensor
built on the device inside the program.  A host tensor copied to the
device inside the program is the same class, paid on every call.

Threshold: ``TraceRegistry.gv104_const_bytes`` (default 2 MiB) — the
cached resize matrices and small trace-time tables are the idiom and stay
below it.
"""

from __future__ import annotations

from typing import Iterator, Set, Tuple

from raft_stereo_tpu_torch.analysis.core import Finding
from raft_stereo_tpu_torch.analysis.trace.checkers.gv101_dtype_discipline import \
    packet
from raft_stereo_tpu_torch.analysis.trace.runner import TraceChecker, TraceContext


class ConstantBloatChecker(TraceChecker):
    code = "GV104"
    name = "constant-bloat"
    description = ("a tensor above the byte threshold held from outside the "
                   "program, or copied from the host inside it")

    def check(self, ctx: TraceContext) -> Iterator[Finding]:
        from raft_stereo_tpu_torch.analysis.trace.graphs import EXTERNAL
        limit = ctx.registry.gv104_const_bytes
        for entry in ctx.registry.all_entries():
            rec = ctx.recording(entry)
            if rec is None:
                continue
            seen: Set[Tuple] = set()
            for op in rec.ops:
                p = packet(op.name)
                for o in op.operands:
                    if o.origin != EXTERNAL or o.nbytes <= limit:
                        continue
                    key = ("held", op.site, o.dtype, o.shape)
                    if key in seen:
                        continue
                    seen.add(key)
                    yield self.finding(
                        entry.name,
                        f"program reads a {list(o.shape)} {o.dtype} tensor "
                        f"({o.nbytes / 2**20:.1f} MiB > "
                        f"{limit / 2**20:.1f} MiB limit) that is neither an "
                        "input, a parameter or buffer, nor produced in the "
                        f"program, at {op.site or 'an unknown site'} — a "
                        "closure- or cache-held tensor lives in every "
                        "captured graph's memory; pass it as an input or "
                        "build it on the device inside the program")
                host_copy = (
                    (p == "_to_copy" and op.operands and op.outs and
                     op.operands[0].device == "cpu" and op.outs[0].device != "cpu")
                    or (p == "copy_" and len(op.operands) >= 2 and
                        op.operands[0].device != "cpu" and
                        op.operands[1].device == "cpu"))
                if host_copy:
                    src = op.operands[1] if p == "copy_" else op.operands[0]
                    key = ("copy", op.site, src.dtype, src.shape)
                    if src.nbytes > limit and key not in seen:
                        seen.add(key)
                        yield self.finding(
                            entry.name,
                            f"program copies a {list(src.shape)} {src.dtype} "
                            f"host tensor ({src.nbytes / 2**20:.1f} MiB) to "
                            f"the device at {op.site or 'an unknown site'} — "
                            "paid on every call; make it an input or build "
                            "it on the device")
