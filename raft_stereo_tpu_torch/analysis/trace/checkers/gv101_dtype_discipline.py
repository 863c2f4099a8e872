"""GV101 — dtype discipline in the refinement loop of a bf16 entry.

Under the eval bf16 policy the refinement loop must compute in bf16: a
silent ``.float()`` of a big tensor inside the loop doubles that tensor's
memory traffic and moves its ops to fp32 — ``iters`` times per frame.
These casts are invisible to every numeric test (fp32 is MORE accurate).

Allowed upcasts — the accumulator set:

- one whose result reaches the fp32 ``coords1`` accumulator (an op at the
  loop's accumulator line, ``models/raft_stereo.py``) within two
  elementwise hops;
- one whose result reaches a reduction (a sum, a mean, ``var_mean``, an
  average pool) within two elementwise hops: fp32 accumulation over bf16
  maps is the sanctioned pattern;
- anything inside a hand-written kernel: invisible on the card, and on the
  CPU its plain version stands in (exempt, as a Pallas body is in the JAX
  package).

Everything else is a finding, one a (site, entry); its context is
``upcast@<module>:<function>`` so that one table suppression covers a
site in every entry.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from raft_stereo_tpu_torch.analysis.core import Finding
from raft_stereo_tpu_torch.analysis.trace.runner import TraceChecker, TraceContext

#: Ops a legal fp32-statistics upcast may pass through on its way.
GLUE = frozenset({
    "add", "sub", "mul", "div", "neg", "pow", "square", "abs", "maximum",
    "minimum", "clamp", "clamp_min", "clamp_max", "view", "_unsafe_view",
    "reshape", "expand", "permute", "transpose", "t", "squeeze", "unsqueeze",
    "slice", "select", "cat", "stack", "clone", "contiguous", "alias",
    "detach", "flatten", "unflatten",
})

#: Reduction-class ops: an upcast consumed by one of these is fp32
#: ACCUMULATION.
REDUCTIONS = frozenset({
    "sum", "mean", "var_mean", "var", "std", "std_mean", "avg_pool2d",
    "avg_pool3d", "_adaptive_avg_pool2d", "adaptive_avg_pool2d", "amax",
    "amin", "max", "min", "norm", "linalg_vector_norm", "_foreach_norm",
    "prod", "logsumexp", "native_batch_norm", "_native_batch_norm_legit",
    "native_group_norm",
})

#: Ops that read only an operand's shape, never its values.
SHAPE_ONLY = frozenset({
    "zeros_like", "ones_like", "empty_like", "full_like", "new_zeros",
    "new_ones", "new_empty", "new_full", "sym_size", "sym_stride",
})

#: How many elementwise hops an upcast may take to its sink.
HOPS = 2


def packet(name: str) -> str:
    """``aten.sum.dim_IntList`` -> ``sum``."""
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else parts[0]


def _feeds(label: str, after: int, uses, depth: int) -> bool:
    consumers = [op for op in uses.get(label, []) if op.index > after]
    if not consumers:
        return False
    for op in consumers:
        p = packet(op.name)
        if op.at_acc or p in REDUCTIONS or p in SHAPE_ONLY:
            continue
        if p in GLUE and depth > 0 and op.outs and all(
                _feeds(o.label, op.index, uses, depth - 1) for o in op.outs):
            continue
        return False
    return True


def upcasts(rec, min_elements: int):
    """``(op, source operand)`` of every bf16->fp32 conversion in the loop,
    outside the kernels, of at least ``min_elements`` elements."""
    for op in rec.ops:
        if not op.in_loop or op.in_kernel:
            continue
        p = packet(op.name)
        if p == "_to_copy" and op.operands and op.outs:
            src, dst = op.operands[0], op.outs[0]
        elif p == "copy_" and len(op.operands) >= 2:
            dst, src = op.operands[0], op.operands[1]
        else:
            continue
        if src.dtype == "bfloat16" and dst.dtype == "float32" and \
                src.numel >= min_elements:
            yield op, src, dst


class DtypeDisciplineChecker(TraceChecker):
    code = "GV101"
    name = "dtype-discipline"
    description = ("bf16->f32 upcast in the refinement loop outside the "
                   "accumulator set (mixed-precision entries)")

    def check(self, ctx: TraceContext) -> Iterator[Finding]:
        from raft_stereo_tpu_torch.analysis.trace.graphs import uses as uses_of
        min_el = ctx.registry.gv101_min_elements
        for entry in ctx.registry.entries:
            if not entry.mixed_precision:
                continue
            rec = ctx.recording(entry)
            if rec is None:
                continue
            uses = uses_of(rec)
            hits: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
            for op, src, dst in upcasts(rec, min_el):
                if _feeds(dst.label, op.index, uses, HOPS):
                    continue
                n, shape = hits.get(op.site or "?", (0, src.shape))
                hits[op.site or "?"] = (n + 1, shape)
            for site, (n, shape) in sorted(hits.items()):
                yield self.finding(
                    f"upcast@{site}",
                    f"{entry.name}: {n} bf16->f32 upcast(s) of tensors like "
                    f"{list(shape)} in the refinement loop at {site}: the "
                    "result reaches neither the loop's fp32 accumulator "
                    f"(coords1) nor a reduction within {HOPS} elementwise hops "
                    "— fp32 "
                    "COMPUTE paid every iteration, not fp32 accumulation; "
                    "keep the map in bf16 or add a registry suppression with "
                    "the measured justification")
