"""graftlock — the concurrency contract suite (GC201-GC206).

Third static-analysis stage beside graftlint (AST, GL) and graftverify
(trace, GV): builds one :class:`LockModel` over the full file set, runs
the six GC checkers through the shared :func:`run_checkers` runner
(same suppression/stale/meta semantics, meta code GC200), and owns the
``LOCK_ORDER.md`` manifest ceremony.  The manifest lives in the first
analyzed root: ``raft_stereo_tpu_torch/LOCK_ORDER.md`` for the port's
package (the CLI's default root), never the JAX package's file at the
repo root.  Stdlib-only, like the GL stage.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Set

from raft_stereo_tpu_torch.analysis.concurrency.checkers import \
    ALL_CONCURRENCY_CHECKERS
from raft_stereo_tpu_torch.analysis.concurrency.graph import (MANIFEST_NAME,
                                                        build_lock_graph,
                                                        render_manifest)
from raft_stereo_tpu_torch.analysis.concurrency.model import LockModel
from raft_stereo_tpu_torch.analysis.core import (CONCURRENCY_META_CODE,
                                           META_CODES, Project, Report,
                                           collect_files, run_checkers)


def build_concurrency_report(project: Project, *,
                             manifest_text: Optional[str] = None,
                             check_manifest: bool = True,
                             emit_file_meta: bool = True,
                             manifest_label: str = MANIFEST_NAME) -> Report:
    """Run GC201-GC206 over an already-built project.  A manifest finding
    is reported at ``manifest_label`` (the manifest's path under the
    analysis base)."""
    model = LockModel(project)
    checkers = [cls(model, manifest_text=manifest_text,
                    check_manifest=check_manifest,
                    manifest_label=manifest_label)
                for cls in ALL_CONCURRENCY_CHECKERS]
    return run_checkers(project, checkers,
                        meta_code=CONCURRENCY_META_CODE,
                        emit_file_meta=emit_file_meta,
                        stale_prefix="GC")


def run_concurrency_analysis(roots: Sequence[str], *,
                             base: Optional[str] = None,
                             manifest_path: Optional[str] = None,
                             check_manifest: bool = True,
                             emit_file_meta: bool = True,
                             select: Optional[Sequence[str]] = None,
                             only_paths: Optional[Set[str]] = None
                             ) -> Report:
    """Analyze ``roots`` with the GC suite end to end.

    manifest_path: the committed ``LOCK_ORDER.md`` to check against
        (default: ``LOCK_ORDER.md`` in the first root); a missing file is a
        GC201 finding unless ``check_manifest`` is off.
    emit_file_meta: False when this report merges into an AST-stage
        report that already carries parse-error/reasonless-suppression
        findings (they must not appear twice).
    """
    files = collect_files(roots, base=base)
    project = Project(files)
    path = manifest_path or _default_manifest(roots)
    label = os.path.relpath(path, _label_base(base, roots)).replace(
        os.sep, "/")
    report = build_concurrency_report(project,
                                      manifest_text=_read_manifest(path),
                                      check_manifest=check_manifest,
                                      emit_file_meta=emit_file_meta,
                                      manifest_label=label)
    by_rel = {sf.relpath: sf.abspath for sf in files}

    def keep(f) -> bool:
        if select is not None and f.code not in META_CODES and \
                f.code not in select:
            return False
        if only_paths is not None and f.path != label and \
                by_rel.get(f.path) not in only_paths:
            return False
        return True
    return Report([f for f in report.findings if keep(f)],
                  [f for f in report.suppressed if keep(f)],
                  report.files_analyzed)


def write_lock_order_manifest(roots: Sequence[str], *,
                              base: Optional[str] = None,
                              manifest_path: Optional[str] = None) -> str:
    """Regenerate ``LOCK_ORDER.md`` (in the first root unless
    ``manifest_path`` says where) from the tree; returns the path."""
    files = collect_files(roots, base=base)
    model = LockModel(Project(files))
    text = render_manifest(build_lock_graph(model))
    path = manifest_path or _default_manifest(roots)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)
    return path


def _first_root_dir(roots: Sequence[str]) -> str:
    root = os.path.abspath(roots[0]) if roots else os.getcwd()
    return root if os.path.isdir(root) else os.path.dirname(root)


def _default_manifest(roots: Sequence[str]) -> str:
    return os.path.join(_first_root_dir(roots), MANIFEST_NAME)


def _label_base(base: Optional[str], roots: Sequence[str]) -> str:
    return os.path.abspath(base) if base else _first_root_dir(roots)


def _read_manifest(path: str) -> Optional[str]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return None


__all__ = ["ALL_CONCURRENCY_CHECKERS", "LockModel", "MANIFEST_NAME",
           "build_concurrency_report", "run_concurrency_analysis",
           "write_lock_order_manifest"]
