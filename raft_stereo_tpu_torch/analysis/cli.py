"""``python -m raft_stereo_tpu_torch.analysis`` — the port's graftlint /
graftverify CLI.

Default: the AST suite (GL001-GL006, stdlib only, a few seconds). With
``--trace``, ALSO runs graftverify (GV101-GV105): records the port's real
entry points (the serving programs ``serve/session.py`` ``build_program``
returns, the eval forward, the train step) op by op under a
``TorchDispatchMode``, with the hand-written kernels' launches in the same
stream, and checks the recorded programs.  Both stages merge into one
verdict / JSON artifact.

The ladder and knob proofs run only at ``--trace-geometry headline`` and
only on a CUDA device: on the CPU every kernel wrapper runs its plain
version, so a rung or knob that turns a kernel off records the same
program there.  Asked for headline without a CUDA device the CLI exits 2.

Exit codes: 0 clean (suppressed findings allowed), 1 unsuppressed
findings, 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from raft_stereo_tpu_torch.analysis.core import git_changed_files, run_analysis

_REPO_MARKERS = ("pyproject.toml", ".git")


def _repo_root(start: str) -> str:
    cur = os.path.abspath(start)
    while True:
        if any(os.path.exists(os.path.join(cur, m)) for m in _REPO_MARKERS):
            return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            return os.path.abspath(start)
        cur = nxt


def _default_roots() -> List[str]:
    """The package directory itself — works from any CWD."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_stereo_tpu_torch.analysis",
        description="graftlint over the port: static analysis for the "
                    "repo's recurring bug classes (GL001-GL006), and with "
                    "--trace graftverify (GV101-GV105).")
    p.add_argument("paths", nargs="*",
                   help="files/directories to analyze (default: the "
                        "raft_stereo_tpu_torch package)")
    p.add_argument("--changed-only", action="store_true",
                   help="report findings only for git-changed files (the "
                        "full tree is still analyzed for cross-file "
                        "context)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSON report on stdout")
    p.add_argument("--select", metavar="CODES",
                   help="comma-separated finding codes to report "
                        "(e.g. GL001,GL004); GL000 and GV000 always report")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also print suppressed findings (with reasons)")
    p.add_argument("--list-checkers", action="store_true",
                   help="print the checker table and exit")
    p.add_argument("--trace", action="store_true",
                   help="also run graftverify (GV101-GV105): record the "
                        "real entry points op by op and check the "
                        "recorded programs (needs torch; headline needs a "
                        "CUDA device)")
    p.add_argument("--trace-geometry", choices=("headline", "small"),
                   default=None,
                   help="recording shapes: 'headline' (2016x2976, 32 "
                        "iterations, the ladder and knob proofs included; "
                        "a CUDA device only) or 'small' (a fast check of "
                        "every entry on any device, without the probes)")
    p.add_argument("--trace-registry", metavar="FILE",
                   help="load the trace registry from a python file "
                        "defining build_registry() instead of the "
                        "default — tests point this at poisoned fixture "
                        "registries to prove each GV checker fires")
    return p


def _load_registry_file(path: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location("_graftverify_fixture",
                                                  path)
    if spec is None or spec.loader is None:
        raise ValueError(f"cannot load trace registry from {path!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_registry()


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.trace and (args.trace_registry or args.trace_geometry):
        # A trace option without --trace would silently skip the trace
        # stage — the analyzer quietly not running must never read as
        # "clean" (the GV000 principle, applied to the CLI itself).
        print("graftlint: --trace-registry/--trace-geometry require "
              "--trace", file=sys.stderr)
        return 2
    if args.list_checkers:
        from raft_stereo_tpu_torch.analysis.checkers import ALL_CHECKERS
        for cls in ALL_CHECKERS:
            print(f"{cls.code}  {cls.name:<24} {cls.description}")
        # The GV table imports without torch (checker modules defer their
        # torch-touching work to check()), so always list it too.
        from raft_stereo_tpu_torch.analysis.trace.checkers import \
            ALL_TRACE_CHECKERS
        for cls in ALL_TRACE_CHECKERS:
            print(f"{cls.code}  {cls.name:<24} {cls.description}")
        return 0
    geometry = args.trace_geometry or "headline"
    if args.trace and not args.trace_registry and geometry == "headline":
        from raft_stereo_tpu_torch.analysis.trace.registry import \
            headline_refusal
        refusal = headline_refusal()
        if refusal is not None:
            # The probes need the kernels: on the CPU every wrapper runs
            # its plain version, so a rung or knob that turns a kernel off
            # is not shown to change what the card runs — neither a
            # finding nor a clean report would prove anything there.
            print(f"graftverify: {refusal}", file=sys.stderr)
            return 2
    roots = args.paths or _default_roots()
    for r in roots:
        if not os.path.exists(r):
            print(f"graftlint: no such path: {r}", file=sys.stderr)
            return 2
    base = _repo_root(roots[0])
    only_paths = None
    if args.changed_only:
        try:
            only_paths = git_changed_files(base)
        except Exception as e:
            print(f"graftlint: --changed-only needs a git checkout: {e}",
                  file=sys.stderr)
            return 2
    select = None
    if args.select:
        select = tuple(c.strip() for c in args.select.split(",") if c.strip())
    try:
        report = run_analysis(roots, base=base, select=select,
                              only_paths=only_paths)
    except Exception as e:  # an internal error must not read as "clean"
        print(f"graftlint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    if args.trace:
        # The trace stage analyzes whole programs, not files —
        # --changed-only's path filter applies to the AST report only.
        try:
            if args.trace_registry:
                registry = _load_registry_file(args.trace_registry)
            else:
                from raft_stereo_tpu_torch.analysis.trace import \
                    default_registry
                registry = default_registry(geometry)
            from raft_stereo_tpu_torch.analysis.trace import \
                run_trace_analysis
            report = report.merged(
                run_trace_analysis(registry, select=select))
        except Exception as e:
            print(f"graftverify: internal error: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
    print(report.render_json() if args.as_json
          else report.render_text(show_suppressed=args.show_suppressed))
    return 0 if report.ok else 1
