"""graftverify runner: record entries once, run the GV checkers, fold table
suppressions into a :class:`~raft_stereo_tpu_torch.analysis.core.Report`.

Mirrors ``analysis/core.run_checkers``' contract: GV000 (recording and
internal meta findings) is never suppressible and never filterable by
``--select`` — an entry that fails to record, or a reasonless suppression,
must not be able to read as "clean".
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

from raft_stereo_tpu_torch.analysis.core import Finding, Report
from raft_stereo_tpu_torch.analysis.trace.registry import TraceEntry, TraceRegistry

#: Meta-code for graftverify itself: recording failures, reasonless
#: suppressions. Not suppressible, not selectable-away.
GV_META_CODE = "GV000"


class TraceChecker:
    """One GV finding code. Subclasses set the class attrs and implement
    :meth:`check`. Use :meth:`finding` so contexts (the suppression keys)
    stay uniform: ``trace:<entry-or-probe-name>``."""

    code: str = "GV???"
    name: str = ""
    description: str = ""

    def check(self, ctx: "TraceContext") -> Iterator[Finding]:
        return iter(())

    def finding(self, context: str, message: str) -> Finding:
        return Finding(self.code, message, f"trace:{context}", 0)


def _env_overrides(env: Dict[str, Optional[str]]):
    # The session's own window (serve/session.py), imported late: fixture
    # registries run without the serving stack loaded.
    from raft_stereo_tpu_torch.serve.session import _env_overrides as window
    return window(env)


class TraceContext:
    """Per-run cache of recorded programs, shared by all checkers so each
    entry runs once however many checkers read it."""

    def __init__(self, registry: TraceRegistry):
        self.registry = registry
        self._recordings: Dict[str, object] = {}  # name -> Recording | Exception
        self._texts: Dict[str, str] = {}
        self._codes = None
        self._region = None

    def _recorder_args(self):
        if self._codes is None:
            from raft_stereo_tpu_torch.analysis.trace.graphs import plain_codes
            self._codes = plain_codes(self.registry.kernel_modules)
            self._region = (self.registry.region() if self.registry.region
                            is not None else None)
        return self._codes, self._region

    # Every accessor returns None on a failed entry — the failure itself
    # is reported exactly once, by trace_errors().

    def recording(self, entry: TraceEntry):
        cached = self._recordings.get(entry.name)
        if cached is not None:
            return None if isinstance(cached, Exception) else cached
        try:
            from raft_stereo_tpu_torch.analysis.trace.graphs import record
            codes, region = self._recorder_args()
            with _env_overrides(dict(entry.env)) if entry.env else \
                    contextlib.nullcontext():
                built = entry.build()
                fn, args, state = built if len(built) == 3 else (*built, None)
                rec = record(fn, args, state, kernel_codes=codes, region=region)
        except Exception as e:  # noqa: BLE001 — converted to GV000
            self._recordings[entry.name] = e
            return None
        finally:
            _release_cache()
        self._recordings[entry.name] = rec
        return rec

    def text(self, entry: TraceEntry) -> Optional[str]:
        if entry.name not in self._texts:
            from raft_stereo_tpu_torch.analysis.trace.graphs import scrubbed_text
            rec = self.recording(entry)
            if rec is None:
                return None
            self._texts[entry.name] = scrubbed_text(rec)
        return self._texts[entry.name]

    def trace_errors(self) -> List[Finding]:
        out = []
        for name in sorted(self._recordings):
            e = self._recordings[name]
            if isinstance(e, Exception):
                out.append(Finding(
                    GV_META_CODE,
                    f"entry failed to record: {type(e).__name__}: {e}",
                    f"trace:{name}", 0))
        return out

    @property
    def entries_traced(self) -> int:
        return sum(1 for v in self._recordings.values()
                   if not isinstance(v, Exception))

    def recorded(self) -> Dict[str, object]:
        """name -> Recording of every entry that recorded."""
        return {k: v for k, v in self._recordings.items()
                if not isinstance(v, Exception)}


def _release_cache() -> None:
    """Give the allocator's cached blocks back between recordings: one
    headline program's activations are not kept for the next."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_trace_analysis(registry: TraceRegistry, *,
                       select: Optional[Sequence[str]] = None,
                       checkers: Optional[Sequence[TraceChecker]] = None,
                       context: Optional[TraceContext] = None) -> Report:
    """Record + check + suppress; the trace-side half of ``--trace``.
    Pass ``context`` to read its recordings afterwards."""
    if checkers is None:
        from raft_stereo_tpu_torch.analysis.trace.checkers import \
            ALL_TRACE_CHECKERS
        checkers = [c() for c in ALL_TRACE_CHECKERS]
    ctx = context if context is not None else TraceContext(registry)
    raw: List[Finding] = []
    # Record every declared entry first: a dead entry is a finding even if
    # no checker would have touched it (the analyzer must not silently
    # shrink).
    for entry in registry.all_entries():
        ctx.recording(entry)
    for checker in checkers:
        raw.extend(checker.check(ctx))
    raw.extend(ctx.trace_errors())

    sup = registry.suppressions
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        context_ = f.path[len("trace:"):] if f.path.startswith("trace:") \
            else f.path
        reason = sup.get((f.code, context_))
        if f.code != GV_META_CODE and reason is not None and reason.strip():
            suppressed.append(dataclasses.replace(
                f, suppressed=True, suppress_reason=reason.strip()))
        else:
            # Blank includes whitespace-only — a reasonless suppression
            # must not be able to hide anything, itself included.
            if f.code != GV_META_CODE and reason is not None:
                active.append(Finding(
                    GV_META_CODE,
                    f"suppression for ({f.code}, {context_!r}) has no "
                    "reason — registry suppressions must say why",
                    f.path, 0))
            active.append(f)

    def keep(f: Finding) -> bool:
        return (select is None or f.code == GV_META_CODE
                or f.code in select)
    return Report([f for f in active if keep(f)],
                  [f for f in suppressed if keep(f)],
                  files_analyzed=0, entries_traced=ctx.entries_traced)
