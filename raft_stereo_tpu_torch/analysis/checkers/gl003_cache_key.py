"""GL003 — program-cache fingerprint completeness.

The serving fingerprint (``serve/session.py`` ``config_fingerprint``)
must cover EVERY model-config field: a field left out lets two different
configs alias one compiled program (the cache-key drift class the JAX
package's review rounds caught by hand, e.g. corr_implementation-only-
differs).

Mechanized as an AST cross-check: the function named
``config_fingerprint`` either iterates ``dataclasses.fields(...)``
(conservative-by-default — a new config field is covered automatically,
the shipped pattern) or must literally mention every field of the
``RAFTStereoConfig`` dataclass (string constants, ``cfg.<field>``
attribute reads, or ``getattr(cfg, "<field>")``).  Adding a config field
while hand-enumerating the fingerprint fails the lint until the
fingerprint names it.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from raft_stereo_tpu_torch.analysis.checkers.base import Checker
from raft_stereo_tpu_torch.analysis.core import Finding, Project

FINGERPRINT_FUNC = "config_fingerprint"
CONFIG_CLASS = "RAFTStereoConfig"


def _mentioned_fields(fn: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "getattr" and len(node.args) >= 2 and \
                isinstance(node.args[1], ast.Constant):
            out.add(node.args[1].value)
    return out


def _uses_dataclasses_fields(sf, fn: ast.FunctionDef) -> bool:
    # canonical() resolves both `import dataclasses [as dc]` and
    # `from dataclasses import fields [as f]` to "dataclasses.fields";
    # an arbitrary helper merely NAMED fields must not disable the check.
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                sf.canonical(node.func) == "dataclasses.fields":
            return True
    return False


class CacheKeyCompletenessChecker(Checker):
    code = "GL003"
    name = "cache-key-completeness"
    description = ("program fingerprint does not cover every model-config "
                   "field (two configs could alias one compiled program)")

    def check_project(self, project: Project) -> Iterator[Finding]:
        fields = project.config_fields(CONFIG_CLASS)
        if fields is None:
            return  # config class outside the analyzed set — cannot check
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.FunctionDef) and
                        node.name == FINGERPRINT_FUNC):
                    continue
                if _uses_dataclasses_fields(sf, node):
                    continue  # generic iteration covers every field
                missing = [f for f in fields
                           if f not in _mentioned_fields(node)]
                for f in missing:
                    yield self.finding(
                        sf, node,
                        f"{CONFIG_CLASS} field {f!r} is not covered by "
                        f"{FINGERPRINT_FUNC} — two configs differing only "
                        "in it would share one compiled program; add it "
                        "to the fingerprint (or iterate "
                        "dataclasses.fields so new fields are "
                        "conservative-by-default)")
