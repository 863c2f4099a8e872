"""GC202 — Future lifecycle in serve/.

The abandoned-Future bug class, machine-checked: a ``Future()`` minted in serve/
parks a caller thread on ``.result()``; abandon it on any path and that
caller blocks forever.  Every minted Future must therefore either

- be handed to a REGISTERED drain (``contracts.FUTURE_DRAINS`` — sinks
  whose owner's ``stop()`` provably resolves parked Futures, the
  reviewed drain contract), or
- be returned to the caller before anything can raise (a factory — the
  caller owns the obligation), or
- be resolved inline, in which case every call made BETWEEN the moment
  the Future escapes to a waiter and its resolution must sit under a
  ``try`` whose handler/finally resolves it (the exception path is the
  one an abandoned Future hides on).

Path-insensitive by design: linenos order events, a ``try`` ancestor
with a resolving handler is the protection proof.  Futures that never
escape before resolution carry no risk — an exception simply propagates
to the only thread that knows about them.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from raft_stereo_tpu_torch.analysis.concurrency.checkers.base import \
    ConcurrencyChecker
from raft_stereo_tpu_torch.analysis.concurrency.contracts import (
    FUTURE_DIRS, FUTURE_DRAINS, FUTURE_FACTORIES, in_dirs)
from raft_stereo_tpu_torch.analysis.concurrency.model import lexical_nodes
from raft_stereo_tpu_torch.analysis.core import (Finding, Project, SourceFile,
                                           ancestors)

#: Attribute calls on the Future that discharge the obligation.
RESOLVE_ATTRS = frozenset({"set_result", "set_exception", "cancel"})


def _is_resolve(node: ast.AST, var: str) -> bool:
    return (isinstance(node, ast.Call) and
            isinstance(node.func, ast.Attribute) and
            node.func.attr in RESOLVE_ATTRS and
            isinstance(node.func.value, ast.Name) and
            node.func.value.id == var)


def _call_tail(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return "<call>"


class _Escape:
    def __init__(self, kind: str, sink: str, node: ast.AST):
        self.kind = kind    # "drain" | "sink" | "return"
        self.sink = sink
        self.node = node
        self.line = getattr(node, "lineno", 0)


class FutureLifecycleChecker(ConcurrencyChecker):
    code = "GC202"
    name = "future-lifecycle"
    description = ("Future minted in serve/ abandoned on some path — not "
                   "resolved, handed to an unregistered sink, or "
                   "unprotected calls between escape and resolution")

    def check_file(self, project: Project, sf: SourceFile
                   ) -> Iterator[Finding]:
        if not in_dirs(sf.relpath, FUTURE_DIRS):
            return
        for fn in ast.walk(sf.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(sf, fn)

    def _check_function(self, sf: SourceFile, fn: ast.AST
                        ) -> Iterator[Finding]:
        for var, creation in self._minted(sf, fn):
            yield from self._check_future(sf, fn, var, creation)

    @staticmethod
    def _minted(sf: SourceFile, fn: ast.AST
                ) -> List[Tuple[str, ast.Assign]]:
        out = []
        for node in lexical_nodes(fn):
            if (isinstance(node, ast.Assign) and
                    len(node.targets) == 1 and
                    isinstance(node.targets[0], ast.Name) and
                    isinstance(node.value, ast.Call) and
                    sf.canonical(node.value.func) in FUTURE_FACTORIES):
                out.append((node.targets[0].id, node))
        return out

    def _check_future(self, sf: SourceFile, fn: ast.AST, var: str,
                      creation: ast.Assign) -> Iterator[Finding]:
        resolves: List[ast.Call] = []
        escapes: List[_Escape] = []
        for node in ast.walk(fn):   # resolves may live in callbacks
            if _is_resolve(node, var):
                resolves.append(node)
            elif (isinstance(node, ast.Name) and node.id == var and
                  isinstance(node.ctx, ast.Load)):
                esc = self._classify_escape(fn, var, node)
                if esc is not None:
                    escapes.append(esc)
        drain = min((e.line for e in escapes if e.kind == "drain"),
                    default=None)
        sinks = [e for e in escapes if e.kind == "sink"]
        returns = [e for e in escapes if e.kind == "return"]
        if not resolves and drain is None:
            if sinks:
                e = sinks[0]
                yield Finding(
                    self.code,
                    f"Future '{var}' handed to unregistered sink "
                    f"'{e.sink}' with no set_result/set_exception in "
                    f"{fn.name}() — register the drain in "
                    "contracts.FUTURE_DRAINS (with a stop()-drains "
                    "proof) or resolve on every path",
                    sf.relpath, e.line)
            elif not returns:
                yield Finding(
                    self.code,
                    f"Future '{var}' created but never resolved or "
                    f"handed off in {fn.name}() — its waiter blocks "
                    "forever",
                    sf.relpath, creation.lineno)
            return
        # Risky window: after the first escape to a waiter, before the
        # obligation is discharged (registered drain, or last resolve).
        start = min((e.line for e in sinks), default=None)
        if start is None:
            return
        end = drain if drain is not None else \
            max(r.lineno for r in resolves) if resolves else None
        if end is None:
            return  # the no-resolve/no-drain case was flagged above
        risky = self._first_risky(fn, var, start, end)
        if risky is not None:
            yield Finding(
                self.code,
                f"Future '{var}' escapes at line {start} but "
                f"'{_call_tail(risky.func)}' at line {risky.lineno} can "
                "raise before it is resolved — wrap in try/except "
                "set_exception, or hand the Future to a registered drain",
                sf.relpath, risky.lineno)

    def _classify_escape(self, fn: ast.AST, var: str, name: ast.Name
                         ) -> Optional[_Escape]:
        prev: ast.AST = name
        for a in ancestors(name):
            if a is fn:
                return None
            if isinstance(a, ast.Call):
                if prev is a.func or (isinstance(a.func, ast.Attribute)
                                      and a.func.value is name):
                    return None  # receiver: a resolve or a query
                tail = _call_tail(a.func)
                kind = "drain" if tail in FUTURE_DRAINS else "sink"
                return _Escape(kind, tail, a)
            if isinstance(a, (ast.Return, ast.Yield)):
                return _Escape("return", "", a)
            if isinstance(a, ast.Assign) and prev is not a.targets[0]:
                for t in a.targets:
                    if isinstance(t, ast.Name):
                        return None  # plain alias — not tracked
                tail = getattr(a.targets[0], "attr", "<store>")
                return _Escape("sink", tail, a)
            prev = a
        return None

    def _first_risky(self, fn: ast.AST, var: str, start: int, end: int
                     ) -> Optional[ast.Call]:
        cands = [n for n in lexical_nodes(fn)
                 if isinstance(n, ast.Call) and start < n.lineno < end]
        for call in sorted(cands, key=lambda c: (c.lineno, c.col_offset)):
            if _is_resolve(call, var):
                continue
            if (isinstance(call.func, ast.Attribute) and
                    isinstance(call.func.value, ast.Name) and
                    call.func.value.id == var):
                continue  # query on the Future itself
            if any(isinstance(a, ast.Call) and _is_resolve(a, var)
                   for a in ancestors(call)):
                continue  # argument of the resolve — part of resolution
            if self._protected(fn, var, call):
                continue
            return call
        return None

    @staticmethod
    def _protected(fn: ast.AST, var: str, call: ast.Call) -> bool:
        for a in ancestors(call):
            if a is fn:
                return False
            if isinstance(a, ast.Try):
                recovery = list(a.finalbody)
                for h in a.handlers:
                    recovery.extend(h.body)
                for stmt in recovery:
                    if any(_is_resolve(n, var) for n in ast.walk(stmt)):
                        return True
        return False
