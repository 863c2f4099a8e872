"""GC204 — callback/sink/IO invocation under a held lock.

The trace-sink rule, generalized: user-registered callbacks and
file IO have unbounded latency and can re-enter the caller, so they
must not run under a state lock.  The carve-out that makes the sink rule
idiomatic is honored: a lock whose NAME declares it a dedicated IO
serializer (``_sink_lock``, ``_disk_lock`` — :data:`contracts.
IO_LOCK_NAME_RE`) is allowed to cover IO, because serializing the sink
is its entire job and it is never nested under state locks (GC201's
graph proves that part).
"""

from __future__ import annotations

from typing import Iterator

from raft_stereo_tpu_torch.analysis.concurrency.checkers.base import \
    ConcurrencyChecker
from raft_stereo_tpu_torch.analysis.concurrency.checkers.gc203_blocking_under_lock \
    import held_contexts
from raft_stereo_tpu_torch.analysis.concurrency.contracts import (is_io_lock,
                                                            is_sink_call)
from raft_stereo_tpu_torch.analysis.core import Finding, Project


class SinkUnderLockChecker(ConcurrencyChecker):
    code = "GC204"
    name = "sink-under-lock"
    description = ("registered callback/sink or file IO invoked while "
                   "holding a non-IO lock")

    def check_project(self, project: Project) -> Iterator[Finding]:
        for key in sorted(self.model.functions):
            summary = self.model.functions[key]
            sf = summary.sf
            for call in summary.calls:
                canonical = sf.canonical(call.node.func)
                if not canonical or not is_sink_call(canonical):
                    continue
                for held, via in held_contexts(self.model, summary, call):
                    state_locks = sorted(k for k in held
                                         if not is_io_lock(k))
                    if not state_locks:
                        continue
                    yield Finding(
                        self.code,
                        f"sink/IO call '{canonical}' in "
                        f"{summary.qualname}() under "
                        + ", ".join(f"`{k}`" for k in state_locks)
                        + (f" (reached via {via})" if via else "")
                        + " — snapshot under the lock, invoke the sink "
                        "outside it (or use a dedicated *_sink_lock)",
                        sf.relpath, call.node.lineno, call.node.col_offset)
                    break
