"""GC201 — the whole-repo lock-order graph.

Two findings share the code:

- a CYCLE in the graph (lock A taken under B somewhere, B under A
  elsewhere — a deadlock waiting for its interleaving);
- DRIFT between the regenerated graph and the committed
  ``LOCK_ORDER.md`` manifest (the bench-checksum ceremony applied to
  acquisition order: a new edge must show up in a reviewed diff, not
  slide in silently).

Cycle findings land on the source line of the first edge in the cycle;
drift findings land on the manifest itself, which is not a python file,
so they are by construction unsuppressable — regenerate and review.
"""

from __future__ import annotations

from typing import Iterator, Optional

from raft_stereo_tpu_torch.analysis.concurrency.checkers.base import \
    ConcurrencyChecker
from raft_stereo_tpu_torch.analysis.concurrency.graph import (
    MANIFEST_NAME, build_lock_graph, find_cycles, manifest_drift)
from raft_stereo_tpu_torch.analysis.concurrency.model import LockModel
from raft_stereo_tpu_torch.analysis.core import Finding, Project


class LockOrderChecker(ConcurrencyChecker):
    code = "GC201"
    name = "lock-order-graph"
    description = ("lock-order cycle across the repo, or drift between "
                   "the tree and the committed LOCK_ORDER.md manifest")

    def __init__(self, model: LockModel, *,
                 manifest_text: Optional[str] = None,
                 check_manifest: bool = False,
                 manifest_label: str = MANIFEST_NAME, **_kw):
        super().__init__(model)
        self.manifest_text = manifest_text
        self.check_manifest = check_manifest
        self.manifest_label = manifest_label

    def check_project(self, project: Project) -> Iterator[Finding]:
        edges = build_lock_graph(self.model)
        for cyc in find_cycles(edges):
            ring = cyc + [cyc[0]]
            first = edges[(ring[0], ring[1])]
            sites = "; ".join(
                edges[(a, b)].example for a, b in zip(ring, ring[1:])
                if (a, b) in edges)
            yield Finding(
                self.code,
                "lock-order cycle: " + " -> ".join(f"`{n}`" for n in ring)
                + f" (edge sites: {sites}) — pick one global order and "
                "restructure the out-of-order acquisition",
                first.relpath, first.line)
        if self.check_manifest:
            drift = manifest_drift(edges, self.manifest_text)
            if drift is not None:
                yield Finding(self.code, drift, self.manifest_label, 1)
