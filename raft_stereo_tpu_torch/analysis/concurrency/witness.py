"""graftlock runtime witness — proves LOCK_ORDER.md against executions.

The static graph (GC201) claims to contain every nested acquisition the
tree can perform.  The witness closes the loop from the other side: a
test-only instrumented wrapper around ``threading.Lock``/``RLock``
records the ACTUAL acquisition orders a running battery produces, and
:func:`unexplained_edges` asserts every observed edge maps into the
static graph.  An edge the model missed (a lock taken through a code
path the AST resolution can't see) fails the witness step instead of
hiding until the interleaving ships.

Mechanics:

- :class:`LockWitness` is a context manager that patches the
  ``threading`` factories.  Locks are identified by CREATION SITE — the
  first stack frame inside ``raft_stereo_tpu_torch/`` at mint time — which is
  exactly the declaration site the static model keys on
  (``LockModel.decl_at`` joins the two by line-range).  Locks minted
  dynamically (per-key ``setdefault`` maps) or outside the package
  (stdlib queue/logging internals) don't map to a declaration and are
  skipped, mirroring the model's own scope.
- Per-thread held stacks; each successful acquire under a non-empty
  stack records one ``(outer_site, inner_site)`` edge.  RLock re-entry
  and Condition ``wait`` (via ``_release_save``/``_acquire_restore``)
  keep the stack honest.
- Locks created BEFORE the witness arms (module-level locks minted at
  import) are not wrapped by the factories; batteries construct their
  serving stack inside the witness, and :meth:`LockWitness.
  adopt_module_locks` wraps the module-level locks the model declares in
  place (``kernels._lock``, ``serve/session.py``'s ``_ENV_LOCK`` and
  ``_GATES_LOCK``), keyed on their declaration lines.  Instance locks of
  objects built before arming (a ``_CaptureGate`` an earlier session made
  for the device) stay unseen: arm before the first session of a process.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

from raft_stereo_tpu_torch.analysis.concurrency.graph import build_lock_graph
from raft_stereo_tpu_torch.analysis.concurrency.model import LockModel
from raft_stereo_tpu_torch.analysis.core import module_dotted

Site = Tuple[str, int]  # (relpath under the repo root, lineno)

_PKG = "raft_stereo_tpu_torch"


def _creation_site() -> Optional[Site]:
    """First stack frame inside the package (excluding this module) —
    the declaration site of the lock being minted."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename.replace(os.sep, "/")
        if f"/{_PKG}/" in fn and not fn.endswith("witness.py"):
            idx = fn.rfind(f"/{_PKG}/")
            return (fn[idx + 1:], f.f_lineno)
        f = f.f_back
    return None


class _WitnessLock:
    """Wraps one real lock; reports acquisition order to the witness."""

    def __init__(self, inner, witness: "LockWitness",
                 site: Optional[Site]):
        self._inner = inner
        self._w = witness
        self.site = site

    # -- the recorded surface ----------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._w._note_acquire(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._w._note_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition integration ---------------------------------------------
    # Condition probes for these; implementing them here (instead of
    # letting __getattr__ expose the inner lock's versions) keeps the
    # witness's held-stack consistent across cv.wait()'s full release
    # and re-acquire.

    def _release_save(self):
        fn = getattr(self._inner, "_release_save", None)
        self._w._note_release_all(self)
        if fn is not None:
            return fn()
        self._inner.release()
        return None

    def _acquire_restore(self, saved) -> None:
        fn = getattr(self._inner, "_acquire_restore", None)
        if fn is not None:
            fn(saved)
        else:
            self._inner.acquire()
        self._w._note_acquire(self)

    def _is_owned(self) -> bool:
        fn = getattr(self._inner, "_is_owned", None)
        if fn is not None:
            return fn()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<witnessed {self._inner!r} @ {self.site}>"


class LockWitness:
    """Patch ``threading.Lock``/``RLock`` and record acquisition edges.

    ``edges`` after (or during) the run: a set of
    ``((relpath, line), (relpath, line))`` pairs — inner acquired while
    outer was the top of the acquiring thread's held stack."""

    def __init__(self):
        self.edges: Set[Tuple[Site, Site]] = set()
        self._guard = threading.Lock()  # minted pre-patch: never wrapped
        self._tls = threading.local()
        self._orig: Dict[str, object] = {}
        #: (module, attribute, original lock) of every adopted lock
        self._adopted: List[Tuple[object, str, object]] = []

    # -- patching ----------------------------------------------------------

    def __enter__(self) -> "LockWitness":
        self._orig = {"Lock": threading.Lock, "RLock": threading.RLock}
        witness = self

        def make(factory):
            def mint(*a, **kw):
                return _WitnessLock(factory(*a, **kw), witness,
                                    _creation_site())
            return mint
        threading.Lock = make(self._orig["Lock"])
        threading.RLock = make(self._orig["RLock"])
        return self

    def __exit__(self, *exc) -> None:
        threading.Lock = self._orig["Lock"]
        threading.RLock = self._orig["RLock"]
        for mod, attr, orig in reversed(self._adopted):
            setattr(mod, attr, orig)
        self._adopted.clear()

    def adopt_module_locks(self, model: LockModel) -> List[str]:
        """Wrap, in place, every module-level Lock/RLock ``model`` declares
        whose module is imported and whose lock was minted before the
        witness armed; the site is the declaration's line.  ``__exit__``
        puts the originals back.  Conditions are left alone (a wrapped
        Condition's ``wait`` would release behind the witness's back).
        Returns the adopted locks' keys."""
        out = []
        for key in sorted(model.decls):
            decl = model.decls[key]
            if decl.owner or decl.kind == "condition":
                continue
            mod = sys.modules.get(module_dotted(decl.relpath))
            lock = getattr(mod, decl.attr, None) if mod is not None else None
            if lock is None or isinstance(lock, _WitnessLock):
                continue
            setattr(mod, decl.attr,
                    _WitnessLock(lock, self, (decl.relpath, decl.lineno)))
            self._adopted.append((mod, decl.attr, lock))
            out.append(key)
        return out

    def module_locks_seen(self, model: LockModel) -> Dict[str, bool]:
        """For every module-level Lock/RLock ``model`` declares whose module
        is imported: whether the witness sees it (minted while armed, or
        adopted)."""
        out = {}
        for key in sorted(model.decls):
            decl = model.decls[key]
            mod = sys.modules.get(module_dotted(decl.relpath))
            if decl.owner or decl.kind == "condition" or mod is None:
                continue
            out[key] = isinstance(getattr(mod, decl.attr, None), _WitnessLock)
        return out

    # -- recording ---------------------------------------------------------

    def _stack(self) -> List["_WitnessLock"]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _note_acquire(self, lock: _WitnessLock) -> None:
        st = self._stack()
        if st and lock.site is not None:
            top = st[-1]
            if top is not lock and top.site is not None and \
                    top.site != lock.site:
                with self._guard:
                    self.edges.add((top.site, lock.site))
        st.append(lock)

    def _note_release(self, lock: _WitnessLock) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is lock:
                del st[i]
                return

    def _note_release_all(self, lock: _WitnessLock) -> None:
        st = self._stack()
        st[:] = [l for l in st if l is not lock]


def package_model() -> LockModel:
    """The LockModel of the installed package tree, keyed with repo-root
    relpaths (``raft_stereo_tpu_torch/...``) — the same node names the witness
    sites resolve to."""
    from raft_stereo_tpu_torch.analysis.core import Project, collect_files
    pkg_dir = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    files = collect_files([pkg_dir], base=os.path.dirname(pkg_dir))
    return LockModel(Project(files))


def unexplained_edges(witness: LockWitness,
                      model: Optional[LockModel] = None) -> List[str]:
    """Observed edges that the static graph does not contain — each one
    is a witness failure.  Edges with an endpoint that maps to no static
    declaration (dynamic/stdlib locks) are out of the model's scope and
    skipped."""
    if model is None:
        model = package_model()
    static = set(build_lock_graph(model))
    out: List[str] = []
    for src, dst in sorted(witness.edges):
        a = model.decl_at(*src)
        b = model.decl_at(*dst)
        if a is None or b is None or a.key == b.key:
            continue
        if (a.key, b.key) not in static:
            out.append(
                f"observed lock edge `{a.key}` -> `{b.key}` "
                f"(minted at {src[0]}:{src[1]} and {dst[0]}:{dst[1]}) "
                "is not in the static lock-order graph — extend the "
                "model or reorder the acquisition")
    return out
