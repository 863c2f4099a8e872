"""graftlock shared model: lock declarations, held-lock stacks, and the
call-graph propagation every GC checker and the lock-order graph build
on.  Stdlib-only, AST-only — the concurrency stage must stay as fast and
environment-independent as the GL stage it rides beside.

The model is deliberately lexical-plus-one-calls-layer:

- a lock NODE is a declaration site — ``self._x = threading.Lock()``
  inside a class (node ``path::Class._x``) or a module-level
  ``_x = threading.Lock()`` (node ``path::_x``).  Locks minted
  dynamically (``setdefault(key, threading.Lock())`` per-key maps) have
  no stable identity and stay outside the model; the runtime witness
  skips them for the same reason.
- the HELD STACK at an AST node is the ordered chain of ``with <lock>``
  items between the node and its enclosing function def.  Nested
  function defs reset the stack: a closure handed to a Thread runs on a
  thread that holds nothing.
- a ``try: ... finally: <lock>.release()`` region counts as holding
  the released lock — the manual ``acquire(blocking=False)`` idiom the
  watchdog's one-sweep-at-a-time gate uses is a real held region even
  though no ``with`` appears.
- calls that resolve inside the repo (``self.m()``, ``self._attr.m()``
  through the attr→class map, module functions, cross-module functions)
  are edges in a call graph; :func:`propagate_entry_contexts` pushes
  held sets through it so a helper only ever called under a lock is
  analyzed as holding that lock (the GL004→GC205 upgrade: cross-file,
  not single-class).
- a ``with`` over a call of a repo context manager that acquires the
  lock it is handed (``serve/session.py``'s ``_held(_ENV_LOCK)``: an
  acquire with a timeout, released in its ``finally``) holds that lock
  for the body; a call whose receiver is another call resolves through
  the inner call's return annotation (``_gate(dev).alone()`` reaches
  ``_CaptureGate.alone``, which takes the gate's condition); a call the
  AST cannot resolve may be declared in :data:`contracts.DYNAMIC_CALLS`
  with the repo functions it reaches.
- a def nested in another function is its own node, named
  ``outer.inner``: a closure never stands in for a method of the same
  name.
- receivers this repo leaves unannotated (``self._clock``, a local
  ``reg``) resolve DUCK-TYPED: a method name defined by at most
  :data:`DUCK_MAX_CANDIDATES` repo classes resolves to ALL of them —
  the runtime witness proved these chains produce real lock edges, so
  over-approximating a small tie beats dropping the edge.  Names every
  container/stdlib object also carries (:data:`DUCK_DENYLIST`) never
  duck-resolve, and neither do calls whose receiver is an imported
  module.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from raft_stereo_tpu_torch.analysis.concurrency.contracts import \
    DYNAMIC_CALLS
from raft_stereo_tpu_torch.analysis.core import Project, SourceFile, parent

#: threading factory tails that mint a lock-like object.  Condition is a
#: lock for ordering purposes (``with cond:`` acquires its inner lock).
LOCK_FACTORY_TAILS = ("Lock", "RLock", "Condition")

#: duck-typed call resolution: a method name defined by more classes
#: than this stays unresolved (a 2-3-way tie like FakeClock/RealClock
#: ``now`` is fine — lock-free candidates contribute nothing).
DUCK_MAX_CANDIDATES = 3

#: method names too generic to duck-resolve — every queue/dict/file/
#: Future/Thread carries them, so a small repo-class tie would hijack
#: stdlib calls and fabricate held-context propagation.
DUCK_DENYLIST = frozenset({
    "get", "put", "put_nowait", "pop", "append", "add", "remove",
    "items", "keys", "values", "update", "copy", "clear", "setdefault",
    "join", "start", "stop", "run", "close", "open", "read", "write",
    "send", "recv", "sleep", "acquire", "release", "wait", "notify",
    "notify_all", "result", "set", "set_result", "set_exception",
    "cancel", "submit", "flush", "next", "reset",
})


@dataclasses.dataclass(frozen=True)
class LockDecl:
    """One statically-declared lock."""

    key: str        # "pkg/serve/fleet.py::Fleet._lock" | "pkg/native/__init__.py::_lock"
    relpath: str
    owner: str      # class name, or "" for module-level locks
    attr: str
    kind: str       # "lock" | "rlock" | "condition"
    lineno: int     # first line of the creating assignment
    end_lineno: int  # last line (witness creation-site match is a range)


def lexical_nodes(fn: ast.AST):
    """Descendants of ``fn`` excluding nested function/lambda bodies — a
    closure's statements run on some other thread at some other time, so
    lexical analyses must not attribute them to the enclosing frame."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        todo.extend(ast.iter_child_nodes(node))


def _self_attr_chain(expr: ast.expr) -> Optional[List[str]]:
    """``self.a.b.c`` -> ["a", "b", "c"]; None when not rooted at self."""
    parts: List[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name) and cur.id == "self":
        return list(reversed(parts))
    return None


@dataclasses.dataclass(frozen=True)
class CallSite:
    node: ast.Call
    stack: Tuple[str, ...]            # lexically-held lock keys, outer→inner
    #: in-repo resolution candidates (relpath, class|"", func) — one
    #: entry for an exact resolution, several for a duck-typed tie,
    #: empty for out-of-repo calls
    targets: Tuple[Tuple[str, str, str], ...]


@dataclasses.dataclass(frozen=True)
class AcquireSite:
    key: str
    stack: Tuple[str, ...]            # locks held when this one is taken
    node: ast.AST


@dataclasses.dataclass
class FunctionSummary:
    sf: SourceFile
    cls_name: str                     # "" for module-level functions
    fn: ast.AST                       # FunctionDef / AsyncFunctionDef
    #: ``fn.name``, or ``outer.inner`` for a def nested in a function
    name: str = ""
    acquisitions: List[AcquireSite] = dataclasses.field(default_factory=list)
    calls: List[CallSite] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.name:
            self.name = self.fn.name

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.sf.relpath, self.cls_name, self.name)

    @property
    def qualname(self) -> str:
        return (f"{self.cls_name}.{self.name}" if self.cls_name
                else self.name)


class LockModel:
    """Whole-project lock + call-graph model, built once per run and
    shared by every GC checker (the expensive part is one AST pass)."""

    def __init__(self, project: Project):
        self.project = project
        self.decls: Dict[str, LockDecl] = {}
        #: attr name -> decls carrying it (cross-object resolution)
        self.by_attr: Dict[str, List[LockDecl]] = {}
        #: (relpath, cls) -> lock attr names of that class
        self.class_locks: Dict[Tuple[str, str], Set[str]] = {}
        #: relpath -> module-level lock names
        self.module_locks: Dict[str, Set[str]] = {}
        #: class name -> [(relpath, ClassDef, sf)]
        self.classes: Dict[str, List[Tuple[str, ast.ClassDef, SourceFile]]] = {}
        #: (relpath, cls) -> {self attr -> (relpath, cls) of its value type}
        self.attr_types: Dict[Tuple[str, str], Dict[str, Tuple[str, str]]] = {}
        #: (relpath, cls, attr) bindings that callers may substitute
        #: (defaulted-dependency idiom with an un-annotated parameter)
        self.attr_open: Set[Tuple[str, str, str]] = set()
        #: method name -> [(relpath, cls)] across every repo class
        self.methods_by_name: Dict[str, List[Tuple[str, str]]] = {}
        #: (relpath, cls, fname) -> (relpath, cls) from `-> Class` returns
        self.fn_return_class: Dict[Tuple[str, str, str],
                                   Tuple[str, str]] = {}
        #: (relpath, cls|"", fname) -> FunctionSummary
        self.functions: Dict[Tuple[str, str, str], FunctionSummary] = {}
        #: dotted module path -> relpath ("a.b.c" for "a/b/c.py")
        self.modules: Dict[str, str] = {}
        #: function key -> index of the argument whose lock it acquires
        #: (None: it acquires none it is handed)
        self._forwards: Dict[Tuple[str, str, str], Optional[int]] = {}
        self._index()
        self._summarize()
        self.entry_contexts = propagate_entry_contexts(self)

    # -- pass 1: declarations ---------------------------------------------

    def _index(self) -> None:
        for sf in self.project.files:
            if sf.tree is None:
                continue
            mod = sf.relpath[:-3].replace("/", ".")
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            self.modules[mod] = sf.relpath
            for node in sf.tree.body:
                self._maybe_lock_assign(sf, "", node)
            for cls in ast.walk(sf.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                self.classes.setdefault(cls.name, []).append(
                    (sf.relpath, cls, sf))
                for sub in cls.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self.methods_by_name.setdefault(
                            sub.name, []).append((sf.relpath, cls.name))
                for sub in ast.walk(cls):
                    self._maybe_lock_assign(sf, cls.name, sub)
        # second sweep: every class is registered, so attr→type and
        # return-annotation edges can resolve forward references too
        for sf in self.project.files:
            if sf.tree is None:
                continue
            for fn in sf.tree.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ret = self._annotation_class(fn.returns)
                    if ret is not None:
                        self.fn_return_class[(sf.relpath, "", fn.name)] = ret
            for cls in ast.walk(sf.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                for sub in cls.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        ret = self._annotation_class(sub.returns)
                        if ret is not None:
                            self.fn_return_class[
                                (sf.relpath, cls.name, sub.name)] = ret
                for sub in cls.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        params: Dict[str, Tuple[str, str]] = {}
                        for arg in (sub.args.args + sub.args.kwonlyargs):
                            t = self._annotation_class(arg.annotation)
                            if t is not None:
                                params[arg.arg] = t
                        for node in ast.walk(sub):
                            self._maybe_attr_type(sf, cls.name, node,
                                                  params)
                    else:
                        for node in ast.walk(sub):
                            self._maybe_attr_type(sf, cls.name, node, {})

    def _annotation_class(self, ann: Optional[ast.expr]
                          ) -> Optional[Tuple[str, str]]:
        """``-> Counter`` / ``-> "Counter"`` / ``-> mod.Counter`` resolved
        to a repo class (Optional[...]/quoted forms included)."""
        if ann is None:
            return None
        if isinstance(ann, ast.Subscript):  # Optional[X] / "X | None" etc
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.strip("'\" ")
        elif isinstance(ann, ast.Name):
            name = ann.id
        elif isinstance(ann, ast.Attribute):
            name = ann.attr
        else:
            return None
        return self._class_by_name(name)

    def _lock_kind(self, sf: SourceFile, value: ast.expr) -> Optional[str]:
        if not isinstance(value, ast.Call):
            return None
        tail = sf.canonical(value.func).split(".")[-1]
        if tail in LOCK_FACTORY_TAILS:
            return tail.lower().replace("rlock", "rlock")
        return None

    def _maybe_lock_assign(self, sf: SourceFile, cls_name: str,
                           node: ast.AST) -> None:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            return
        value = node.value
        if value is None:
            return
        kind = self._lock_kind(sf, value)
        if kind is None:
            return
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            attr: Optional[str] = None
            if cls_name:
                chain = _self_attr_chain(t)
                if chain is not None and len(chain) == 1:
                    attr = chain[0]
            elif isinstance(t, ast.Name):
                attr = t.id
            if attr is None:
                continue
            key = (f"{sf.relpath}::{cls_name}.{attr}" if cls_name
                   else f"{sf.relpath}::{attr}")
            decl = LockDecl(key, sf.relpath, cls_name, attr, kind,
                            node.lineno,
                            getattr(node, "end_lineno", node.lineno))
            self.decls[key] = decl
            self.by_attr.setdefault(attr, []).append(decl)
            if cls_name:
                self.class_locks.setdefault(
                    (sf.relpath, cls_name), set()).add(attr)
            else:
                self.module_locks.setdefault(sf.relpath, set()).add(attr)

    def _maybe_attr_type(self, sf: SourceFile, cls_name: str,
                         node: ast.AST,
                         params: Dict[str, Tuple[str, str]]) -> None:
        """``self.X = SomeRepoClass(...)``, ``self.X = reg.counter(...)``
        (return-annotated factory) or ``self.X = param`` (annotated
        parameter) -> attr→class edge — the seam that lets
        ``self._gauge.set()`` resolve into obs/metrics.py.

        A defaulted-dependency binding whose injected branch stays
        untyped (``clock if clock is not None else RealClock()`` with an
        un-annotated ``clock``) is recorded as **open** in
        :attr:`attr_open`: callers may substitute any duck-compatible
        class, so call resolution through an open attr unions the typed
        default with the duck candidates."""
        if not isinstance(node, ast.Assign):
            return
        value = node.value
        # `X()`, `arg if arg is not None else X()`, `arg or X()` — the
        # defaulted-dependency idiom types the attr by its default class
        branches: List[ast.expr] = [value]
        if isinstance(value, ast.IfExp):
            branches = [value.body, value.orelse]
        elif isinstance(value, ast.BoolOp):
            branches = list(value.values)
        target: Optional[Tuple[str, str]] = None
        open_binding = False
        for branch in branches:
            got: Optional[Tuple[str, str]] = None
            if isinstance(branch, ast.Call):
                got = self._value_class(sf, branch)
            elif isinstance(branch, ast.Name):
                got = params.get(branch.id)
                if got is None:
                    # an injected parameter without a resolvable
                    # annotation: the binding stays substitutable
                    open_binding = True
                    continue
            else:
                continue
            if got is None:
                continue
            if target is not None and got != target:
                return  # ambiguous branches: leave the attr untyped
            target = got
        if target is None:
            return
        for t in node.targets:
            chain = _self_attr_chain(t)
            if chain is not None and len(chain) == 1:
                self.attr_types.setdefault(
                    (sf.relpath, cls_name), {})[chain[0]] = target
                if open_binding:
                    self.attr_open.add((sf.relpath, cls_name, chain[0]))

    def _value_class(self, sf: SourceFile, call: ast.Call
                     ) -> Optional[Tuple[str, str]]:
        """Class a call expression evaluates to: a constructor, or a
        return-annotated factory method (reg.counter(...) -> Counter)."""
        name = sf.canonical(call.func)
        target = self._class_by_name(name.split(".")[-1], hint=name)
        if target is not None or not isinstance(call.func, ast.Attribute):
            return target
        for owner in self._duck_candidates(sf, call.func):
            ret = self.fn_return_class.get(
                (owner[0], owner[1], call.func.attr))
            if ret is None:
                continue
            if target is not None and ret != target:
                return None  # ambiguous tie: different return types
            target = ret
        return target

    def _duck_candidates(self, sf: SourceFile, func: ast.Attribute
                         ) -> List[Tuple[str, str]]:
        """Repo classes a ``<recv>.m(...)`` call may dispatch into when
        nothing types the receiver: every class defining ``m``, capped at
        :data:`DUCK_MAX_CANDIDATES` and gated on the denylist.  Calls
        whose receiver head is an imported module (``time.monotonic()``)
        never duck-resolve — those are stdlib, not repo dispatch."""
        if func.attr in DUCK_DENYLIST:
            return []
        head = func.value
        while isinstance(head, ast.Attribute):
            head = head.value
        if isinstance(head, ast.Name) and head.id in sf.import_aliases:
            return []
        if not isinstance(head, (ast.Name, ast.Attribute)):
            return []  # calls on literals/calls: no stable receiver
        cands = self.methods_by_name.get(func.attr, [])
        if 0 < len(cands) <= DUCK_MAX_CANDIDATES:
            return list(cands)
        return []

    def _class_by_name(self, name: str, hint: str = ""
                       ) -> Optional[Tuple[str, str]]:
        cands = self.classes.get(name, [])
        if len(cands) == 1:
            return (cands[0][0], name)
        if len(cands) > 1 and hint:
            # disambiguate by the canonical dotted prefix when present
            mod_hint = hint.rsplit(".", 1)[0]
            rel = self.modules.get(mod_hint)
            for relpath, _cls, _sf in cands:
                if rel == relpath:
                    return (relpath, name)
        return None

    # -- lock-expression resolution ---------------------------------------

    def resolve_lock(self, sf: SourceFile, cls_name: str,
                     expr: ast.expr) -> Optional[str]:
        """Lock key acquired by ``with <expr>:``, or None when the
        expression is not a statically-known lock."""
        chain = _self_attr_chain(expr)
        if chain is not None:
            if len(chain) == 1:
                if chain[0] in self.class_locks.get(
                        (sf.relpath, cls_name), ()):
                    return f"{sf.relpath}::{cls_name}.{chain[0]}"
                return None
            # self.a.b...attr: follow the attr→class map one hop, else
            # fall back to a unique attr-name match across the repo.
            owner = self.attr_types.get((sf.relpath, cls_name), {}) \
                .get(chain[0])
            if owner is not None and len(chain) == 2 and \
                    chain[1] in self.class_locks.get(owner, ()):
                return f"{owner[0]}::{owner[1]}.{chain[1]}"
            cands = [d for d in self.by_attr.get(chain[-1], ())
                     if d.owner]
            if len(cands) == 1:
                return cands[0].key
            return None
        if isinstance(expr, ast.Name):
            if expr.id in self.module_locks.get(sf.relpath, ()):
                return f"{sf.relpath}::{expr.id}"
            origin = sf.from_imports.get(expr.id)
            if origin is not None:
                mod, _, nm = origin.rpartition(".")
                rel = self.modules.get(mod)
                if rel is not None and nm in self.module_locks.get(rel, ()):
                    return f"{rel}::{nm}"
            return None
        if isinstance(expr, ast.Attribute):
            # non-self receiver (``prog.lock``, ``inst._lock``): a unique
            # instance-lock attr name across the repo is unambiguous
            cands = [d for d in self.by_attr.get(expr.attr, ())
                     if d.owner]
            if len(cands) == 1:
                return cands[0].key
        return None

    # -- pass 2: per-function summaries -----------------------------------

    def _summarize(self) -> None:
        # Register every function FIRST, walk bodies second — call
        # resolution must see the whole repo, not just the functions
        # defined above the caller (forward references are the norm:
        # check_now calls _check_locked defined right below it).
        for sf in self.project.files:
            if sf.tree is None:
                continue
            for fn in ast.walk(sf.tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                cls_name = self._enclosing_class(fn)
                summary = FunctionSummary(sf, cls_name, fn,
                                          self._nested_name(fn))
                # last-definition-wins on duplicate names, matching
                # Python's own rebinding semantics
                self.functions[summary.key] = summary
        for summary in list(self.functions.values()):
            self._walk_body(summary, summary.fn.body, ())

    @staticmethod
    def _nested_name(fn: ast.AST) -> str:
        """``outer.inner`` for a def nested in functions (up to the class
        or module), else the def's own name."""
        names = [fn.name]
        cur = parent(fn)
        while cur is not None and not isinstance(cur, ast.ClassDef):
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.append(cur.name)
            cur = parent(cur)
        return ".".join(reversed(names))

    @staticmethod
    def _enclosing_class(fn: ast.AST) -> str:
        """Nearest enclosing ClassDef — THROUGH intervening function
        defs: a closure nested in a method still closes over that
        method's ``self``, so its ``self.x`` chains type against the
        same class."""
        cur = parent(fn)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur.name
            cur = parent(cur)
        return ""

    def _walk_body(self, summary: FunctionSummary,
                   body: Sequence[ast.stmt],
                   stack: Tuple[str, ...]) -> None:
        for stmt in body:
            self._walk_stmt(summary, stmt, stack)

    def _walk_stmt(self, summary: FunctionSummary, stmt: ast.AST,
                   stack: Tuple[str, ...]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # separate context; the closure's thread holds nothing
        if isinstance(stmt, ast.Try):
            # `try: ... finally: <lock>.release()` is a held region for
            # that lock — the manual acquire(blocking=False) gate idiom.
            inner = stack
            for fin in stmt.finalbody:
                for node in ast.walk(fin):
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Attribute) and \
                            node.func.attr == "release":
                        key = self.resolve_lock(
                            summary.sf, summary.cls_name, node.func.value)
                        if key is not None and key not in inner:
                            summary.acquisitions.append(
                                AcquireSite(key, inner, stmt))
                            inner = inner + (key,)
            self._walk_body(summary, stmt.body, inner)
            self._walk_body(summary, stmt.orelse, inner)
            for handler in stmt.handlers:
                self._walk_stmt(summary, handler, inner)
            self._walk_body(summary, stmt.finalbody, stack)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = stack
            for item in stmt.items:
                self._scan_calls(summary, item.context_expr, inner)
                key = self.resolve_lock(summary.sf, summary.cls_name,
                                        item.context_expr)
                if key is None and isinstance(item.context_expr, ast.Call):
                    key = self._forwarded_lock(summary, item.context_expr)
                if key is not None and key not in inner:
                    summary.acquisitions.append(
                        AcquireSite(key, inner, item.context_expr))
                    inner = inner + (key,)
            self._walk_body(summary, stmt.body, inner)
            return
        # every other statement-ish node (If/Try/For/ExceptHandler/...):
        # scan this level's expressions, recurse into nested statement
        # lists with the same stack
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, (ast.stmt, ast.excepthandler)) or \
                    type(child).__name__ == "match_case":
                self._walk_stmt(summary, child, stack)
            else:
                self._scan_calls(summary, child, stack)

    def _scan_calls(self, summary: FunctionSummary, expr: ast.AST,
                    stack: Tuple[str, ...]) -> None:
        todo: List[ast.AST] = [expr]
        while todo:
            node = todo.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # a closure body's calls must not inherit the outer stack
                continue
            if isinstance(node, ast.Call):
                summary.calls.append(CallSite(
                    node, stack, self._resolve_call(summary, node)))
            todo.extend(ast.iter_child_nodes(node))

    def _forwarded_lock(self, summary: FunctionSummary, call: ast.Call
                        ) -> Optional[str]:
        """The lock ``with f(<lock>):`` holds when ``f`` is a repo context
        manager that acquires the lock it is handed."""
        for target in self._resolve_call(summary, call):
            idx = self._forward_index(target)
            if idx is not None and len(call.args) > idx:
                key = self.resolve_lock(summary.sf, summary.cls_name,
                                        call.args[idx])
                if key is not None:
                    return key
        return None

    def _forward_index(self, target: Tuple[str, str, str]) -> Optional[int]:
        """Index of the call argument whose ``.acquire()`` ``target``'s
        body calls (``self`` not counted), else None."""
        if target not in self._forwards:
            self._forwards[target] = None
            fn = self.functions[target].fn
            params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
            if target[1] and params and params[0] == "self":
                params = params[1:]
            for node in lexical_nodes(fn):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "acquire" and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id in params:
                    self._forwards[target] = params.index(node.func.value.id)
                    break
        return self._forwards[target]

    def _call_class(self, summary: FunctionSummary, call: ast.Call
                    ) -> Optional[Tuple[str, str]]:
        """The repo class a call returns, by its targets' ``-> Class``
        annotations (a constructor returns its class)."""
        ctor = self._ctor(summary.sf, call.func)
        if ctor is not None:
            return (ctor[0], ctor[1])
        out = None
        for t in self._resolve_call(summary, call):
            ret = self.fn_return_class.get(t)
            if ret is None or (out is not None and ret != out):
                return None
            out = ret
        return out

    def _dynamic(self, sf: SourceFile, func: ast.Attribute
                 ) -> Tuple[Tuple[str, str, str], ...]:
        """Targets :data:`contracts.DYNAMIC_CALLS` declares for a call the
        AST cannot resolve."""
        out = []
        for (where, attr), targets in DYNAMIC_CALLS.items():
            if attr != func.attr or not f"/{sf.relpath}".endswith(f"/{where}"):
                continue
            for rel, cls, name in targets:
                for key in self.functions:
                    if key[1:] == (cls, name) and \
                            f"/{key[0]}".endswith(f"/{rel}"):
                        out.append(key)
        return tuple(out)

    def _resolve_call(self, summary: FunctionSummary, call: ast.Call
                      ) -> Tuple[Tuple[str, str, str], ...]:
        out = self._resolve_static(summary, call)
        if not out and isinstance(call.func, ast.Attribute):
            out = self._dynamic(summary.sf, call.func)
        return out

    def _resolve_static(self, summary: FunctionSummary, call: ast.Call
                        ) -> Tuple[Tuple[str, str, str], ...]:
        sf = summary.sf
        func = call.func
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Call):
            # f(...).m(): the class f returns, then its method m
            owner = self._call_class(summary, func.value)
            if owner is not None:
                t = self._method(owner[0], owner[1], func.attr)
                if t is not None:
                    return (t,)
        if isinstance(func, ast.Attribute):
            chain = _self_attr_chain(func)
            if chain is not None:
                if len(chain) == 1:
                    t = self._method(sf.relpath, summary.cls_name,
                                     chain[0])
                    if t is not None:
                        return (t,)
                    return self._duck_methods(sf, func)
                # self.a.b...m(): walk the attr→class map hop by hop
                # (self.session.breaker.status() needs two hops).  A
                # hop through an open binding unions the typed result
                # with the duck candidates — the injected substitute
                # (FakeClock for RealClock) must stay in the graph.
                owner: Optional[Tuple[str, str]] = \
                    (sf.relpath, summary.cls_name)
                open_walk = False
                for hop in chain[:-1]:
                    if (owner[0], owner[1], hop) in self.attr_open:
                        open_walk = True
                    owner = self.attr_types.get(owner, {}).get(hop)
                    if owner is None:
                        break
                if owner is not None:
                    t = self._method(owner[0], owner[1], chain[-1])
                    out = (t,) if t is not None else ()
                    if open_walk:
                        out = tuple(dict.fromkeys(
                            out + self._duck_methods(sf, func)))
                    return out
                return self._duck_methods(sf, func)
            # module-function calls: resolve the dotted head to a module
            name = sf.canonical(func)
            if name:
                mod, _, fn_name = name.rpartition(".")
                rel = self.modules.get(mod)
                if rel is not None:
                    t = self._method(rel, "", fn_name)
                    if t is not None:
                        return (t,)
                t = self._ctor(sf, func)
                if t is not None:
                    return (t,)
            return self._duck_methods(sf, func)
        if isinstance(func, ast.Name):
            origin = sf.from_imports.get(func.id)
            if origin is not None:
                mod, _, nm = origin.rpartition(".")
                rel = self.modules.get(mod)
                if rel is not None:
                    t = self._method(rel, "", nm)
                    if t is not None:
                        return (t,)
                t = self._ctor(sf, func)
                return (t,) if t is not None else ()
            # a def nested in this function (keyed ``outer.inner``), then
            # the class scope, then the module
            t = self._method(sf.relpath, summary.cls_name,
                             f"{summary.name}.{func.id}")
            if t is None and summary.cls_name:
                t = self._method(sf.relpath, summary.cls_name, func.id)
            if t is None:
                t = self._method(sf.relpath, "", func.id)
            if t is None:
                t = self._ctor(sf, func)
            return (t,) if t is not None else ()
        return ()

    def _ctor(self, sf: SourceFile, func: ast.expr
              ) -> Optional[Tuple[str, str, str]]:
        """``ClassName(...)`` resolves into the class's ``__init__`` —
        constructors run caller-side, so a lock acquired while
        instantiating (``with self._lock: self.hb = Heartbeat(...)``)
        is held across everything the initializer does."""
        name = sf.canonical(func)
        if not name:
            return None
        cls = self._class_by_name(name.split(".")[-1], hint=name)
        if cls is None:
            return None
        return self._method(cls[0], cls[1], "__init__")

    def _duck_methods(self, sf: SourceFile, func: ast.Attribute
                      ) -> Tuple[Tuple[str, str, str], ...]:
        out = []
        for relpath, cls in self._duck_candidates(sf, func):
            t = self._method(relpath, cls, func.attr)
            if t is not None:
                out.append(t)
        return tuple(out)

    def _method(self, relpath: str, cls: str, name: str
                ) -> Optional[Tuple[str, str, str]]:
        key = (relpath, cls, name)
        return key if key in self.functions else None

    # -- queries -----------------------------------------------------------

    def held_variants(self, key: Tuple[str, str, str]
                      ) -> List[Tuple[FrozenSet[str], str]]:
        """Entry-held contexts of a function: ``[(held_set, via)]`` where
        ``via`` names an example caller chain (empty for the default
        lock-free entry)."""
        out = [(frozenset(), "")]
        out.extend(self.entry_contexts.get(key, {}).items())
        seen: Dict[FrozenSet[str], str] = {}
        for held, via in out:
            seen.setdefault(held, via)
        return [(frozenset(k), v) for k, v in
                sorted(seen.items(), key=lambda kv: sorted(kv[0]))]

    def decl_at(self, relpath: str, lineno: int) -> Optional[LockDecl]:
        """Declaration covering (relpath, lineno) — the witness's
        creation-site → static-node join."""
        for decl in self.decls.values():
            if decl.relpath == relpath and \
                    decl.lineno <= lineno <= decl.end_lineno:
                return decl
        return None


def propagate_entry_contexts(model: LockModel
                             ) -> Dict[Tuple[str, str, str],
                                       Dict[FrozenSet[str], str]]:
    """Push held-lock sets through the call graph: if ``A.m`` calls
    ``B.n`` while holding {L}, then ``B.n`` has an entry context {L}.
    Bounded: the visited set is (function, frozen held set)."""
    contexts: Dict[Tuple[str, str, str], Dict[FrozenSet[str], str]] = {}
    work: List[Tuple[Tuple[str, str, str], FrozenSet[str], str]] = []
    seen: Set[Tuple[Tuple[str, str, str], FrozenSet[str]]] = set()

    def enqueue(target, held: FrozenSet[str], via: str) -> None:
        if not held or (target, held) in seen:
            return
        seen.add((target, held))
        contexts.setdefault(target, {}).setdefault(held, via)
        work.append((target, held, via))

    for summary in model.functions.values():
        for call in summary.calls:
            if call.stack:
                for target in call.targets:
                    enqueue(target, frozenset(call.stack),
                            summary.qualname)
    while work:
        target, held, via = work.pop()
        summary = model.functions.get(target)
        if summary is None:
            continue
        for call in summary.calls:
            total = held | frozenset(call.stack)
            for nxt in call.targets:
                enqueue(nxt, total, f"{via} -> {summary.qualname}")
    return contexts
