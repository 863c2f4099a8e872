"""GC203 — blocking call while a lock is held.

A blocking call under a lock turns that lock into a convoy: every
thread that needs it queues behind a sleep, a queue.get, a subprocess,
or — worst — a ``Future.result()`` that the lock-holder itself is the
only one able to resolve (the caller-deadlock shape).  Judged per call
site against the reviewed registry in :mod:`contracts`; both lexically
held locks and call-graph-propagated entry contexts count (a helper
only ever invoked under the admission lock blocks the admission lock).

One deliberate carve-out: a blocking call ON a held Condition/lock
itself (``self._cv.wait()`` inside ``with self._cv:``) is the canonical
wait pattern — ``wait`` releases the lock while parked — so the
receiver lock is subtracted before judging; it is still flagged when
OTHER locks remain held across the wait.
"""

from __future__ import annotations

import ast
from typing import FrozenSet, Iterator, List, Tuple

from raft_stereo_tpu_torch.analysis.concurrency.checkers.base import \
    ConcurrencyChecker
from raft_stereo_tpu_torch.analysis.concurrency.contracts import is_blocking_call
from raft_stereo_tpu_torch.analysis.concurrency.model import (CallSite,
                                                        FunctionSummary)
from raft_stereo_tpu_torch.analysis.core import Finding, Project


def held_contexts(model, summary: FunctionSummary, call: CallSite
                  ) -> List[Tuple[FrozenSet[str], str]]:
    """Lock sets this call can run under: the lexical stack when there
    is one, else every nonempty call-graph entry context."""
    if call.stack:
        return [(frozenset(call.stack), "")]
    return [(held, via) for held, via in model.held_variants(summary.key)
            if held]


class BlockingUnderLockChecker(ConcurrencyChecker):
    code = "GC203"
    name = "blocking-under-lock"
    description = ("blocking call (queue.get/join/wait/sleep/subprocess/"
                   "socket/invoke/Future.result) while a lock is held")

    def check_project(self, project: Project) -> Iterator[Finding]:
        for key in sorted(self.model.functions):
            summary = self.model.functions[key]
            sf = summary.sf
            for call in summary.calls:
                canonical = sf.canonical(call.node.func)
                if not canonical:
                    continue
                args = call.node.args
                first_num = bool(args) and \
                    isinstance(args[0], ast.Constant) and \
                    isinstance(args[0].value, (int, float))
                if not is_blocking_call(canonical, len(args), first_num):
                    continue
                for held, via in held_contexts(self.model, summary, call):
                    effective = set(held)
                    if isinstance(call.node.func, ast.Attribute):
                        recv = self.model.resolve_lock(
                            sf, summary.cls_name, call.node.func.value)
                        if recv is not None:
                            # cv.wait() under `with cv:` — wait releases
                            # the cv; only OTHER held locks convoy.
                            effective.discard(recv)
                    if not effective:
                        continue
                    yield Finding(
                        self.code,
                        f"blocking call '{canonical}' in "
                        f"{summary.qualname}() while holding "
                        + ", ".join(f"`{k}`" for k in sorted(effective))
                        + (f" (reached via {via})" if via else "")
                        + " — move the blocking call outside the lock",
                        sf.relpath, call.node.lineno, call.node.col_offset)
                    break  # one finding per call site is enough
