"""GL004 — lock discipline on instance attributes.

The quarantine-dict / metrics-counter race class: a class declares
``self._lock = threading.Lock()`` and guards an attribute's mutations in
one method, while another method mutates the same attribute bare (the
JAX package's loader quarantine and session metrics both shipped a
variant that review caught by hand).  A half-guarded attribute is worse than an
unguarded one — the lock documents an intent the code doesn't keep.

Flagged, per class that owns at least one ``threading.Lock``/``RLock``
attribute:

- an attribute mutated under a ``with self.<lock>`` block in one place
  and outside any such block in another (``__init__`` is exempt —
  construction is single-threaded by convention);
- an attribute whose guarded mutation sites share NO common lock (two
  methods agreeing to lock but not on which lock).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set

from raft_stereo_tpu_torch.analysis.checkers.base import Checker
from raft_stereo_tpu_torch.analysis.core import (Finding, Project, SourceFile,
                                           ancestors)

#: Method names whose receiver object is mutated by the call.
MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "sort", "reverse",
    "move_to_end", "appendleft", "popleft",
})

#: Methods where unguarded mutation is conventional (single-threaded).
EXEMPT_METHODS = ("__init__", "__new__", "__del__")


def _self_attr(expr: ast.expr) -> Optional[str]:
    """The leftmost ``self.<attr>`` an lvalue/receiver chain hangs off:
    ``self.a``, ``self.a[k]``, ``self.a.b`` all resolve to ``a``."""
    while isinstance(expr, (ast.Subscript, ast.Attribute)):
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            return expr.attr
        expr = expr.value
    return None


@dataclasses.dataclass
class _Site:
    node: ast.AST
    method: str
    locks: frozenset  # self-lock attrs held at this site


def _lock_attrs(cls: ast.ClassDef, sf: SourceFile) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = sf.canonical(node.value.func)
            if name.split(".")[-1] in ("Lock", "RLock"):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        out.add(attr)
    return out


def _held_locks(node: ast.AST, locks: Set[str], fn: ast.AST) -> frozenset:
    held = set()
    for a in ancestors(node):
        if a is fn:
            break
        if isinstance(a, ast.With):
            for item in a.items:
                attr = _self_attr(item.context_expr)
                if attr in locks:
                    held.add(attr)
    return frozenset(held)


def _mutation_sites(cls: ast.ClassDef, locks: Set[str]) -> Dict[str,
                                                                List[_Site]]:
    sites: Dict[str, List[_Site]] = {}

    def record(attr: Optional[str], node: ast.AST, method: str,
               fn: ast.AST) -> None:
        if attr is None or attr in locks:
            return
        sites.setdefault(attr, []).append(
            _Site(node, method, _held_locks(node, locks, fn)))

    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name in EXEMPT_METHODS:
            continue
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    record(_self_attr(t), node, fn.name, fn)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    record(_self_attr(t), node, fn.name, fn)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in MUTATORS:
                record(_self_attr(node.func.value), node, fn.name, fn)
    return sites


class LockDisciplineChecker(Checker):
    code = "GL004"
    name = "lock-discipline"
    description = ("instance attribute mutated both inside and outside "
                   "its lock (half-guarded state race)")

    def check_file(self, project: Project, sf: SourceFile
                   ) -> Iterator[Finding]:
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _lock_attrs(cls, sf)
            if not locks:
                continue
            for attr, sites in sorted(_mutation_sites(cls, locks).items()):
                guarded = [s for s in sites if s.locks]
                bare = [s for s in sites if not s.locks]
                if guarded and bare:
                    lock_names = sorted({l for s in guarded for l in s.locks})
                    for s in bare:
                        yield self.finding(
                            sf, s.node,
                            f"{cls.name}.{attr} is mutated under "
                            f"{'/'.join(lock_names)} elsewhere but bare in "
                            f"{s.method}() — take the lock here or move "
                            "the attribute out of locked use")
                elif len(guarded) > 1:
                    common = frozenset.intersection(
                        *[s.locks for s in guarded])
                    if not common:
                        s = guarded[-1]
                        yield self.finding(
                            sf, s.node,
                            f"{cls.name}.{attr} mutation sites hold no "
                            "common lock (" + ", ".join(
                                f"{x.method}: {'/'.join(sorted(x.locks))}"
                                for x in guarded) +
                            ") — agree on one lock for this attribute")
