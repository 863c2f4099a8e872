"""GC205 — ``_*_locked`` helper discipline (the GL004 successor).

The serving code's convention: a method named ``_foo_locked``
documents "caller holds the owning lock".  GL004 can only see
half-guarded attributes inside one class; GC205 enforces the convention
itself, cross-file, via the shared call-graph model:

- a ``_*_locked`` helper may only be called with a lock lexically held,
  from another ``_*_locked`` helper (the contract chains), or from a
  construction-exempt method;
- an attribute that a ``_*_locked`` helper mutates is GUARDED — any
  other method of the class mutating it without a lexically-held lock
  breaks the contract the helper's name advertises.

GL004 stays registered as the fallback for lock patterns this model
cannot resolve (dynamically-minted locks, non-``self`` receivers).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from raft_stereo_tpu_torch.analysis.checkers.gl004_lock_discipline import (
    EXEMPT_METHODS, MUTATORS, _self_attr)
from raft_stereo_tpu_torch.analysis.concurrency.checkers.base import \
    ConcurrencyChecker
from raft_stereo_tpu_torch.analysis.concurrency.contracts import LOCKED_HELPER_RE
from raft_stereo_tpu_torch.analysis.concurrency.model import lexical_nodes
from raft_stereo_tpu_torch.analysis.core import (Finding, Project, SourceFile,
                                           ancestors)


def _mutations(fn: ast.AST) -> List[Tuple[str, ast.AST]]:
    """Lexical ``self.<attr>`` mutation sites of a method."""
    out: List[Tuple[str, ast.AST]] = []
    for node in lexical_nodes(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    out.append((attr, node))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    out.append((attr, node))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATORS:
            attr = _self_attr(node.func.value)
            if attr is not None:
                out.append((attr, node))
    return out


class LockedHelperChecker(ConcurrencyChecker):
    code = "GC205"
    name = "locked-helper-discipline"
    description = ("_*_locked helper called without a held lock, or its "
                   "guarded attributes mutated lock-free elsewhere")

    def check_project(self, project: Project) -> Iterator[Finding]:
        yield from self._check_calls()
        yield from self._check_guarded_attrs()

    # -- rule 1: callers of _*_locked hold a lock ---------------------------

    def _check_calls(self) -> Iterator[Finding]:
        for key in sorted(self.model.functions):
            summary = self.model.functions[key]
            caller = summary.fn.name
            if LOCKED_HELPER_RE.match(caller) or caller in EXEMPT_METHODS:
                continue
            for call in summary.calls:
                func = call.node.func
                callee = func.attr if isinstance(func, ast.Attribute) \
                    else func.id if isinstance(func, ast.Name) else ""
                if not LOCKED_HELPER_RE.match(callee):
                    continue
                if call.stack:
                    continue
                yield Finding(
                    self.code,
                    f"'{callee}' called from {summary.qualname}() with "
                    "no lock lexically held — _*_locked helpers require "
                    "the owning lock at the call site (or a _*_locked "
                    "caller that chains the contract)",
                    summary.sf.relpath, call.node.lineno,
                    call.node.col_offset)

    # -- rule 2: guarded attributes stay behind a lock ----------------------

    def _check_guarded_attrs(self) -> Iterator[Finding]:
        for cls_name in sorted(self.model.classes):
            for relpath, cls, sf in self.model.classes[cls_name]:
                yield from self._check_class(sf, relpath, cls)

    def _check_class(self, sf: SourceFile, relpath: str,
                     cls: ast.ClassDef) -> Iterator[Finding]:
        lock_attrs = self.model.class_locks.get((relpath, cls.name), set())
        methods = [m for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
        guarded: Dict[str, str] = {}   # attr -> guarding helper name
        for m in methods:
            if not LOCKED_HELPER_RE.match(m.name):
                continue
            for attr, _node in _mutations(m):
                if attr not in lock_attrs:
                    guarded.setdefault(attr, m.name)
        if not guarded:
            return
        for m in methods:
            if LOCKED_HELPER_RE.match(m.name) or m.name in EXEMPT_METHODS:
                continue
            for attr, node in _mutations(m):
                helper = guarded.get(attr)
                if helper is None:
                    continue
                if self._held_here(sf, cls.name, node, m):
                    continue
                yield Finding(
                    self.code,
                    f"'self.{attr}' is guarded by {cls.name}.{helper}() "
                    f"but mutated lock-free in {m.name}() — take the "
                    "owning lock or route the mutation through the "
                    "helper",
                    relpath, node.lineno,
                    getattr(node, "col_offset", 0))

    def _held_here(self, sf: SourceFile, cls_name: str, node: ast.AST,
                   fn: ast.AST) -> bool:
        for a in ancestors(node):
            if a is fn:
                return False
            if isinstance(a, (ast.With, ast.AsyncWith)):
                for item in a.items:
                    if self.model.resolve_lock(sf, cls_name,
                                               item.context_expr):
                        return True
        return False
