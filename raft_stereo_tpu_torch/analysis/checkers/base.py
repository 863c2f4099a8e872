"""Checker base class."""

from __future__ import annotations

import ast
from typing import Iterator, List

from raft_stereo_tpu_torch.analysis.core import Finding, Project, SourceFile


class Checker:
    """One finding code.  Subclasses set the class attributes and
    implement either :meth:`check_file` (per-file checkers) or
    :meth:`check_project` (cross-file checkers)."""

    code: str = "GL???"
    name: str = ""
    description: str = ""

    def check_project(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is not None:
                yield from self.check_file(project, sf)

    def check_file(self, project: Project, sf: SourceFile
                   ) -> Iterator[Finding]:
        return iter(())

    def finding(self, sf: SourceFile, node: ast.AST, message: str) -> Finding:
        return Finding(self.code, message, sf.relpath,
                       getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0))


def funcdefs_by_name(tree: ast.AST) -> dict:
    """name -> [FunctionDef] for every def anywhere in the module (nested
    included — closures a program builder returns are nested)."""
    out: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


def call_name_candidates(sf: SourceFile, func: ast.expr) -> List[str]:
    """Dotted-name forms a call target can be matched under: the
    canonical alias-resolved name plus its raw tail (``kernels.entry``
    resolves to ``raft_stereo_tpu_torch.kernels.entry`` AND matches
    ``kernels.entry``)."""
    name = sf.canonical(func)
    if not name:
        return []
    parts = name.split(".")
    return [name] + [".".join(parts[i:]) for i in range(1, len(parts))]
