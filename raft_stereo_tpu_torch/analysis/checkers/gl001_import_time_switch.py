"""GL001 — kill switch read at import scope or cached into a constant.

The JAX package's bug class: a module read its kill switch into a module
constant at import time, so the serving circuit breaker's runtime env flip
silently never took effect — the stale program kept running the kernel the
operator had just killed.  Program-shaping switches must be read when the
program is built, i.e. inside a function every build calls.

Flagged, for any ``RAFT_*`` env key (or a key in the knob registry):

- a read at module or class scope (executes once, at import);
- a read inside a function decorated ``functools.lru_cache`` / ``cache``
  (same staleness with one extra step of indirection).

The port reads its switches through ``config.py`` helpers, so a read also
counts where a call passes the key to a helper that reads the key it is
given (``_switch_on("RAFT_X")``) and where a call reaches a helper whose
body reads the key (``fuse_iter_on()`` at import scope, or inside a cached
function, pins the switch just the same).
"""

from __future__ import annotations

import ast
from typing import Iterator

from raft_stereo_tpu_torch.analysis.checkers.base import Checker
from raft_stereo_tpu_torch.analysis.core import (Finding, Project, SourceFile,
                                                 ancestors, enclosing_function)

_CACHE_DECORATORS = ("functools.lru_cache", "lru_cache", "functools.cache",
                     "cache")


def _is_cached(sf: SourceFile, fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        if sf.canonical(target) in _CACHE_DECORATORS:
            return True
    return False


def _under_main_guard(node: ast.AST) -> bool:
    for a in ancestors(node):
        if isinstance(a, ast.If) and isinstance(a.test, ast.Compare) and \
                isinstance(a.test.left, ast.Name) and \
                a.test.left.id == "__name__" and \
                any(isinstance(c, ast.Constant) and c.value == "__main__"
                    for c in a.test.comparators):
            return True
    return False


class ImportTimeSwitchChecker(Checker):
    code = "GL001"
    name = "import-time-switch"
    description = ("program-shaping env switch read at module import "
                   "scope or cached into a constant (must be read when "
                   "the program is built)")

    def check_file(self, project: Project, sf: SourceFile
                   ) -> Iterator[Finding]:
        sites = [(r.key, r.node, "") for r in project.env_reads(sf)
                 if r.key is not None]
        # A helper called under ``if __name__ == "__main__":`` runs as the
        # program's entry, never at import.
        sites += [(key, call, f" (through {helper.dotted}())")
                  for call, helper in project.helper_calls(sf)
                  if not _under_main_guard(call)
                  for key in sorted(helper.keys)]
        for key, node, how in sites:
            if not (key.startswith("RAFT_") or key in project.knobs):
                continue
            fn = enclosing_function(node)
            if fn is None:
                yield self.finding(
                    sf, node,
                    f"env switch {key!r} read at import scope{how} — a "
                    "runtime flip (circuit-breaker trip, operator export) "
                    "will never take effect; read it inside the function "
                    "that builds the program")
            elif _is_cached(sf, fn):
                yield self.finding(
                    sf, node,
                    f"env switch {key!r} read inside the cached "
                    f"function {getattr(fn, 'name', '<lambda>')!r}{how} — "
                    "the first call pins the value for the process "
                    "lifetime; drop the cache decorator or hoist the read "
                    "to the caller")
