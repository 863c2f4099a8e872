"""GC206 — thread lifecycle in serve/ and obs/.

Every ``threading.Thread(...)`` started in the serving/observability
planes must have a reachable join/stop path: a fire-and-forget thread
outlives ``stop()``, keeps references alive across deploys (the fleet
rolling-deploy invariant), and turns shutdown into a race.  Accepted
proofs, per binding shape:

- ``self._t = Thread(...)`` — some method of the class joins
  ``self._t`` (or hands it to something: escape transfers ownership);
- ``t = Thread(...)`` — the same function joins ``t`` or lets it
  escape (returned, appended to a registry, passed to a reaper);
- ``Thread(...).start()`` — no binding at all: always a finding.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from raft_stereo_tpu_torch.analysis.checkers.gl004_lock_discipline import \
    _self_attr
from raft_stereo_tpu_torch.analysis.concurrency.checkers.base import \
    ConcurrencyChecker
from raft_stereo_tpu_torch.analysis.concurrency.contracts import (THREADED_DIRS,
                                                            in_dirs)
from raft_stereo_tpu_torch.analysis.concurrency.model import lexical_nodes
from raft_stereo_tpu_torch.analysis.core import (Finding, Project, SourceFile,
                                           ancestors, enclosing_function,
                                           parent)


def _enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    for a in ancestors(node):
        if isinstance(a, ast.ClassDef):
            return a
    return None


class ThreadLifecycleChecker(ConcurrencyChecker):
    code = "GC206"
    name = "thread-lifecycle"
    description = ("Thread started in serve//obs/ without a reachable "
                   "join/stop path")

    def check_file(self, project: Project, sf: SourceFile
                   ) -> Iterator[Finding]:
        if not in_dirs(sf.relpath, THREADED_DIRS):
            return
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and \
                    sf.canonical(node.func) == "threading.Thread":
                yield from self._check_thread(sf, node)

    def _check_thread(self, sf: SourceFile, call: ast.Call
                      ) -> Iterator[Finding]:
        p = parent(call)
        if isinstance(p, ast.Attribute):
            if p.attr == "start":
                yield Finding(
                    self.code,
                    "fire-and-forget Thread(...).start() — bind the "
                    "thread and register a join/stop path in the "
                    "owner's stop()/drain",
                    sf.relpath, call.lineno, call.col_offset)
            return
        if isinstance(p, ast.Assign):
            target = p.targets[0]
            if isinstance(target, ast.Name):
                yield from self._check_local(sf, call, target.id)
                return
            attr = _self_attr(target)
            if attr is not None and isinstance(target, ast.Attribute):
                yield from self._check_attr(sf, call, attr)
            return
        # Every other parent shape (call argument, container element,
        # return value, keyword) hands the thread to other machinery —
        # ownership, and the join obligation, transfer with it.

    def _check_local(self, sf: SourceFile, call: ast.Call, name: str
                     ) -> Iterator[Finding]:
        fn = enclosing_function(call)
        scope = fn if fn is not None else sf.tree
        for node in lexical_nodes(scope):
            if not (isinstance(node, ast.Name) and node.id == name and
                    isinstance(node.ctx, ast.Load)):
                continue
            if self._use_discharges(node):
                return
        yield Finding(
            self.code,
            f"Thread '{name}' is started but never joined and never "
            "escapes this function — join it or hand it to a "
            "reaper/registry with a stop path",
            sf.relpath, call.lineno, call.col_offset)

    def _check_attr(self, sf: SourceFile, call: ast.Call, attr: str
                    ) -> Iterator[Finding]:
        cls = _enclosing_class(call)
        scope: ast.AST = cls if cls is not None else sf.tree
        if self._attr_discharged(scope, attr):
            return
        owner = f"{cls.name}." if cls is not None else ""
        yield Finding(
            self.code,
            f"Thread 'self.{attr}' has no join anywhere in "
            f"{owner.rstrip('.') or sf.relpath} — the owner's "
            "stop()/close() must join its worker threads",
            sf.relpath, call.lineno, call.col_offset)

    def _attr_discharged(self, scope: ast.AST, attr: str) -> bool:
        """True when some use of ``self.<attr>`` in ``scope`` joins the
        thread or hands it off — directly, or through a one-hop local
        alias (``t = self._thread; ...; t.join()``, the snapshot-then-
        join idiom stop() methods use against concurrent restarts)."""
        for node in ast.walk(scope):
            if not (isinstance(node, ast.Attribute) and node.attr == attr
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and isinstance(node.ctx, ast.Load)):
                continue
            p = parent(node)
            if isinstance(p, ast.Attribute) and p.attr == "join":
                return True
            if isinstance(p, ast.Assign) and node is p.value:
                for t in p.targets:
                    if isinstance(t, ast.Name) and \
                            self._alias_discharges(p, t.id):
                        return True
            prev: ast.AST = node
            for a in ancestors(node):
                if isinstance(a, ast.Call) and prev is not a.func:
                    return True  # escapes to other machinery
                if isinstance(a, ast.stmt):
                    break
                prev = a
        return False

    def _alias_discharges(self, assign: ast.Assign, alias: str) -> bool:
        fn = enclosing_function(assign)
        if fn is None:
            return False
        return any(isinstance(n, ast.Name) and n.id == alias and
                   isinstance(n.ctx, ast.Load) and self._use_discharges(n)
                   for n in lexical_nodes(fn))

    @staticmethod
    def _use_discharges(name: ast.Name) -> bool:
        """True when this use joins the thread or lets it escape."""
        prev: ast.AST = name
        for a in ancestors(name):
            if isinstance(a, ast.Attribute) and a.value is prev:
                return a.attr == "join"
            if isinstance(a, ast.Call):
                return prev is not a.func   # in args/keywords: escapes
            if isinstance(a, (ast.Return, ast.Yield, ast.Tuple, ast.List,
                              ast.Set, ast.Dict)):
                return True
            if isinstance(a, ast.Assign):
                return not all(isinstance(t, ast.Name) for t in a.targets)
            if isinstance(a, ast.stmt):
                return False
            prev = a
        return False
