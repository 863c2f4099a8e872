"""GL005 — purity of code that a CUDA graph captures or a backward reruns.

In the port, three kinds of Python run once and are then replayed, or run
again later, without their host side:

- the callables ``serve/session.py`` ``build_program`` returns: the session
  captures each as a CUDA graph and every later call replays the graph;
- the body of a ``with torch.cuda.graph(...)`` block;
- a function passed to ``torch.utils.checkpoint.checkpoint``, whose body
  the backward runs again.

An impure host call inside one — ``time.time()``, ``np.random``, an
``os.environ`` read, mutation of a module-level object — becomes a value
baked into the captured graph (or a side effect that fires once per
capture instead of once per call), or differs between the forward and its
recomputation.  The same family as the import-time switch (GL001), one
level down.

The checker inspects the DIRECT body (plus nested defs/lambdas) of those
functions; it does not chase the call graph, so build-time-by-design
helpers (the switch reads ``config.py`` makes when a model path is chosen)
stay out of scope.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from raft_stereo_tpu_torch.analysis.checkers.base import (Checker,
                                                          funcdefs_by_name)
from raft_stereo_tpu_torch.analysis.checkers.gl004_lock_discipline import MUTATORS
from raft_stereo_tpu_torch.analysis.core import (Finding, Project, SourceFile,
                                           ancestors, enclosing_function)

#: The function whose returned callables the session captures.
BUILDER = "build_program"
#: A call that reruns its function argument in the backward.
RECOMPUTE = "torch.utils.checkpoint.checkpoint"
#: A context manager whose body is captured.
CAPTURE = "torch.cuda.graph"

_IMPURE_EXACT = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.sleep",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today", "uuid.uuid4", "os.urandom", "os.getenv",
    "os.environ.get",
}
_IMPURE_PREFIX = ("numpy.random.", "random.")


def _unwrap_partial(sf: SourceFile, expr: ast.expr) -> ast.expr:
    if isinstance(expr, ast.Call) and \
            sf.canonical(expr.func).split(".")[-1] == "partial" and expr.args:
        return expr.args[0]
    return expr


def _resolve_visible(defs, call_node: ast.AST, name: str) -> List[ast.AST]:
    """The defs a Name argument can actually refer to AT the call site,
    Python scoping order: the call's innermost enclosing function first,
    then outward, then module scope — so a host-side namesake of a traced
    closure (e.g. two functions both called ``step``) is never flagged."""
    cands = defs.get(name, [])
    if len(cands) <= 1:
        return cands
    scopes = [a for a in ancestors(call_node)
              if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda))] + [None]
    for scope in scopes:
        matches = [d for d in cands if enclosing_function(d) is scope]
        if matches:
            return matches
    return []


def _traced_functions(sf: SourceFile) -> List[Tuple[ast.AST, str]]:
    """(function node or captured ``with`` block, how it is replayed)
    pairs for this file."""
    defs = funcdefs_by_name(sf.tree)
    out: List[Tuple[ast.AST, str]] = []
    seen: Set[int] = set()

    def add(node: Optional[ast.AST], how: str) -> None:
        if node is not None and id(node) not in seen:
            seen.add(id(node))
            out.append((node, how))

    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name == BUILDER:
            nested = {d.name: d for d in ast.walk(node)
                      if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))
                      and d is not node}
            for ret in ast.walk(node):
                if not isinstance(ret, ast.Return) or ret.value is None:
                    continue
                val = _unwrap_partial(sf, ret.value)
                if isinstance(val, ast.Lambda):
                    add(val, f"{BUILDER}()")
                elif isinstance(val, ast.Name) and val.id in nested:
                    add(nested[val.id], f"{BUILDER}()")
        elif isinstance(node, ast.With):
            if any(isinstance(it.context_expr, ast.Call) and
                   sf.canonical(it.context_expr.func) == CAPTURE
                   for it in node.items):
                add(node, CAPTURE)
        elif isinstance(node, ast.Call) and node.args and \
                sf.canonical(node.func) == RECOMPUTE:
            arg = _unwrap_partial(sf, node.args[0])
            if isinstance(arg, ast.Lambda):
                add(arg, "checkpoint")
            elif isinstance(arg, ast.Name):
                for fd in _resolve_visible(defs, node, arg.id):
                    add(fd, "checkpoint")
    return out


def _local_names(fn: ast.AST) -> Set[str]:
    names: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            names.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and \
                isinstance(node.ctx, (ast.Store, ast.Del)):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
    return names


def _base_name(expr: ast.expr) -> Optional[str]:
    while isinstance(expr, (ast.Subscript, ast.Attribute)):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


class TracePurityChecker(Checker):
    code = "GL005"
    name = "trace-purity"
    description = ("impure host call / global mutation inside code a CUDA "
                   "graph captures (build_program's callables, a "
                   "torch.cuda.graph block) or a checkpoint reruns")

    def check_file(self, project: Project, sf: SourceFile
                   ) -> Iterator[Finding]:
        for fn, how in _traced_functions(sf):
            if isinstance(fn, ast.With):
                # A captured block shares its function's scope.
                scope = enclosing_function(fn)
                fname = f"the {CAPTURE} block" + (
                    f" in {scope.name!r}" if scope is not None and
                    hasattr(scope, "name") else "")
                locals_ = _local_names(scope) if scope is not None else set()
                nodes = [n for stmt in fn.body for n in ast.walk(stmt)]
            else:
                fname = repr(getattr(fn, "name", "<lambda>"))
                locals_ = _local_names(fn)
                nodes = list(ast.walk(fn))
            for node in nodes:
                yield from self._check_node(sf, node, fname, how, locals_)

    def _check_node(self, sf, node, fname, how, locals_):
        if isinstance(node, ast.Call):
            name = sf.canonical(node.func)
            if name in _IMPURE_EXACT or \
                    name.startswith(_IMPURE_PREFIX):
                yield self.finding(
                    sf, node,
                    f"impure call {name}() inside {fname} (replayed via "
                    f"{how}) — it runs once, when the program is captured "
                    "(or again, on recomputation), and its value is baked "
                    "into every replay; hoist it to the caller and pass "
                    "the value in")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in MUTATORS:
                base = _base_name(node.func.value)
                if base and base in sf.module_names and \
                        base not in locals_:
                    yield self.finding(
                        sf, node,
                        f"mutation of module-level {base!r} inside "
                        f"{fname} (replayed via {how}) — the side effect "
                        "fires once per capture, not once per call")
        elif isinstance(node, ast.Subscript):
            if sf.canonical(node.value) == "os.environ" and \
                    isinstance(node.ctx, ast.Load):
                yield self.finding(
                    sf, node,
                    f"os.environ read inside {fname} (replayed via {how}) "
                    "— the value is baked in at capture; resolve it in "
                    "the caller and key the program cache on it")
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, (ast.Subscript, ast.Attribute)):
                    base = _base_name(t)
                    if base and base in sf.module_names and \
                            base not in locals_:
                        yield self.finding(
                            sf, t,
                            f"mutation of module-level {base!r} inside "
                            f"{fname} (replayed via {how}) — the side "
                            "effect fires once per capture, not once per "
                            "call")
        elif isinstance(node, ast.Global):
            yield self.finding(
                sf, node,
                f"`global {', '.join(node.names)}` inside {fname} "
                f"(replayed via {how}) — rebinding module state from "
                "captured code fires once per capture, not once per call")
