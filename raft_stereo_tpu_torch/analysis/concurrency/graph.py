"""The whole-repo lock-order graph (GC201) and its committed manifest.

Every statically-resolvable acquisition nested under a held lock is an
edge ``outer -> inner``; edges also propagate through the call graph
(``A.m`` holds L and calls ``B.n`` which takes K ⇒ edge L -> K).  A
cycle is a deadlock waiting for its interleaving; the acyclic graph is
rendered to the port's ``raft_stereo_tpu_torch/LOCK_ORDER.md`` (the
manifest lives in the analyzed root, never beside the JAX package's) —
regenerated with ``--write-manifest``,
drift fails the gate exactly like the bench-checksum ceremony: the
committed artifact IS the reviewed contract, a silent change to the
acquisition order must show up in the diff.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from raft_stereo_tpu_torch.analysis.concurrency.model import LockModel

MANIFEST_NAME = "LOCK_ORDER.md"

_HEADER = """\
# LOCK_ORDER.md — the committed lock-order graph (graftlock GC201)

Generated by `python -m raft_stereo_tpu_torch.analysis --concurrency
--write-manifest`; checked byte-identical by the gate.  Each line is one
observed-in-source edge `outer -> inner`: somewhere in the tree the
`inner` lock is acquired while `outer` is held (directly, or through a
statically-resolved call chain).  The graph must stay ACYCLIC — a cycle
is GC201 — and the runtime witness asserts every edge real executions
produce is present here.

Node syntax: `path::Class.attr` (instance locks) or `path::name`
(module-level locks).
"""


@dataclasses.dataclass(frozen=True)
class LockEdge:
    src: str
    dst: str
    relpath: str  # first site found: file, line, enclosing function
    line: int
    qual: str
    via: str      # example caller chain for call-graph-propagated edges

    @property
    def example(self) -> str:
        return f"{self.relpath}:{self.line} ({self.qual})" + \
            (f" via {self.via}" if self.via else "")


def build_lock_graph(model: LockModel) -> Dict[Tuple[str, str], LockEdge]:
    """All edges, deterministic: direct lexical nesting plus entry-held
    contexts pushed through the call graph."""
    edges: Dict[Tuple[str, str], LockEdge] = {}

    def add(src: str, dst: str, relpath: str, line: int, qual: str,
            via: str) -> None:
        if src == dst:
            return  # RLock re-entry is not an ordering edge
        edges.setdefault((src, dst),
                         LockEdge(src, dst, relpath, line, qual, via))

    for key in sorted(model.functions):
        summary = model.functions[key]
        for held, via in model.held_variants(key):
            for acq in summary.acquisitions:
                for outer in sorted(held | set(acq.stack)):
                    add(outer, acq.key, summary.sf.relpath,
                        getattr(acq.node, "lineno", summary.fn.lineno),
                        summary.qualname, via)
    return edges


def find_cycles(edges: Dict[Tuple[str, str], LockEdge]
                ) -> List[List[str]]:
    """Elementary cycles via iterative DFS back-edge detection — small
    graphs, so a simple coloring walk is enough; each cycle is reported
    once, rotated to its lexicographically-least node."""
    adj: Dict[str, List[str]] = {}
    for (src, dst) in edges:
        adj.setdefault(src, []).append(dst)
    for dsts in adj.values():
        dsts.sort()
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    path: List[str] = []
    cycles: List[List[str]] = []
    seen: Set[Tuple[str, ...]] = set()

    def visit(node: str) -> None:
        color[node] = GREY
        path.append(node)
        for nxt in adj.get(node, ()):
            c = color.get(nxt, WHITE)
            if c == GREY:
                i = path.index(nxt)
                cyc = path[i:]
                k = cyc.index(min(cyc))
                canon = tuple(cyc[k:] + cyc[:k])
                if canon not in seen:
                    seen.add(canon)
                    cycles.append(list(canon))
            elif c == WHITE:
                visit(nxt)
        path.pop()
        color[node] = BLACK

    for node in sorted(adj):
        if color.get(node, WHITE) == WHITE:
            visit(node)
    return cycles


def render_manifest(edges: Dict[Tuple[str, str], LockEdge]) -> str:
    lines = [_HEADER]
    if not edges:
        lines.append("\n(no nested acquisitions in the tree)\n")
        return "".join(lines)
    lines.append("\n")
    for (src, dst) in sorted(edges):
        lines.append(f"- `{src}` -> `{dst}`\n")
    return "".join(lines)


def manifest_drift(edges: Dict[Tuple[str, str], LockEdge],
                   manifest_text: Optional[str]) -> Optional[str]:
    """None when the committed manifest matches the regenerated one;
    otherwise a one-line description of the drift."""
    want = render_manifest(edges)
    if manifest_text is None:
        return (f"{MANIFEST_NAME} is missing — run --write-manifest and "
                "commit it")
    if manifest_text == want:
        return None
    want_edges = {ln for ln in want.splitlines() if ln.startswith("- ")}
    have_edges = {ln for ln in manifest_text.splitlines()
                  if ln.startswith("- ")}
    added = sorted(want_edges - have_edges)
    removed = sorted(have_edges - want_edges)
    bits = []
    if added:
        bits.append("new edges not in the committed manifest: "
                    + "; ".join(added[:4]))
    if removed:
        bits.append("committed edges no longer in the tree: "
                    + "; ".join(removed[:4]))
    if not bits:
        bits.append("text drift (header/format)")
    return (f"{MANIFEST_NAME} drift — regenerate with --write-manifest "
            "and review the diff (" + " | ".join(bits) + ")")
