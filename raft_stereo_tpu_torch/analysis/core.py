"""graftlint framework over the port: source model, suppressions, runner,
report.

Checkers (``analysis/checkers/``) operate on a :class:`Project` — every
analyzed file pre-parsed to an AST with parent pointers, import-alias
maps and a per-line suppression table.  The project is always built from
the FULL file set so cross-file checkers (GL002/GL003/GL006 read the knob
registry, the config dataclass, the switch helpers and the guard ladder)
see their context even when only a subset of findings is reported
(``--changed-only``).

The port reads its kernel switches through helpers (``config.py``:
``fuse_iter_on()`` reads ``RAFT_FUSE_ITER`` through ``_switch_on``), so
the project also resolves which keys each helper's body reads
(:meth:`Project.env_helpers`): a call to a helper is a read of its keys.

Stdlib only — the linter runs in any environment, without torch.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: Meta-code: suppression syntax errors and unparsable files.  GL000
#: findings are never themselves suppressible (a broken suppression must
#: not be able to hide itself).
META_CODE = "GL000"

#: Meta-code of the graftlock (concurrency) stage — same non-suppressible,
#: non-filterable contract as GL000, emitted by the GC stage
#: (``analysis/concurrency/``) for stale GC-code suppressions and (when the
#: stage runs standalone) parse errors.
CONCURRENCY_META_CODE = "GC200"

#: Codes that are never suppressible and always pass ``--select``.
META_CODES = (META_CODE, CONCURRENCY_META_CODE)

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)"
    r"\s*(\([^)]*\))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding; ``path`` is relative to the analysis root."""

    code: str
    message: str
    path: str
    line: int
    col: int = 0
    suppressed: bool = False
    suppress_reason: str = ""

    def render(self) -> str:
        tag = " (suppressed: %s)" % self.suppress_reason if self.suppressed \
            else ""
        return f"{self.path}:{self.line}:{self.col}: {self.code} " \
               f"{self.message}{tag}"


@dataclasses.dataclass(frozen=True)
class _Suppression:
    codes: Tuple[str, ...]
    reason: str  # empty string == malformed (missing reason)


class SourceFile:
    """One parsed source file plus the lookup tables checkers need."""

    def __init__(self, abspath: str, relpath: str, text: str):
        self.abspath = abspath
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        #: line number -> suppression found on that line
        self.suppressions: Dict[int, _Suppression] = {}
        #: local alias -> canonical dotted module ("_os" -> "os")
        self.import_aliases: Dict[str, str] = {}
        #: local name -> canonical dotted origin ("environ" -> "os.environ")
        self.from_imports: Dict[str, str] = {}
        self.module_names: Set[str] = set()  # names bound at module scope
        try:
            self.tree = ast.parse(text, filename=relpath)
        except SyntaxError as e:  # reported as a GL000 finding by the runner
            self.parse_error = e
            return
        _attach_parents(self.tree)
        self._scan_suppressions()
        self._scan_imports()
        self._scan_module_names()

    # -- construction helpers ---------------------------------------------

    def _scan_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                codes = tuple(c.strip() for c in m.group(1).split(","))
                reason = (m.group(2) or "").strip("() \t")
                self.suppressions[i] = _Suppression(codes, reason)

    def _scan_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.import_aliases[a.asname] = a.name
                    else:
                        # `import os.path` binds the ROOT name `os` — the
                        # alias must map os -> os, not os -> os.path
                        # (which would hide every os.environ read).
                        root = a.name.split(".")[0]
                        self.import_aliases[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def _scan_module_names(self) -> None:
        for node in self.tree.body:
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        self.module_names.add(n.id)

    # -- queries -----------------------------------------------------------

    def canonical(self, node: ast.expr) -> str:
        """Dotted name of an expression with import aliases resolved:
        ``_os.environ.get`` -> ``os.environ.get``; a bare ``environ``
        imported via ``from os import environ`` -> ``os.environ``."""
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if isinstance(cur, ast.Name):
            head = self.from_imports.get(
                cur.id, self.import_aliases.get(cur.id, cur.id))
            parts.append(head)
        elif isinstance(cur, ast.Call):
            # e.g. ``importlib.import_module("os").environ`` — give up on
            # the head but keep the attribute tail for suffix matches.
            parts.append("()")
        else:
            return ""
        return ".".join(reversed(parts))

    def suppression_for(self, line: int) -> Optional[_Suppression]:
        """The suppression governing ``line``: a trailing comment on the
        line itself, or a comment-only line directly above it."""
        sup = self.suppressions.get(line)
        if sup is not None:
            return sup
        prev = self.suppressions.get(line - 1)
        if prev is not None and 1 <= line - 1 <= len(self.lines) and \
                self.lines[line - 2].lstrip().startswith("#"):
            return prev
        return None


def _attach_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._gl_parent = parent  # type: ignore[attr-defined]


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_gl_parent", None)


def ancestors(node: ast.AST) -> Iterable[ast.AST]:
    cur = parent(node)
    while cur is not None:
        yield cur
        cur = parent(cur)


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    """Nearest enclosing FunctionDef/AsyncFunctionDef/Lambda, or None when
    the node executes at import time (module or class scope)."""
    for a in ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return a
    return None


@dataclasses.dataclass(frozen=True)
class EnvRead:
    """One environment-variable read site."""

    key: Optional[str]  # None when the key expression isn't a literal
    node: ast.AST       # the Call / Subscript expression


def env_reads(sf: SourceFile) -> List[EnvRead]:
    """Every ``os.environ.get`` / ``os.environ[...]`` / ``os.getenv``
    site in the file, alias-resolved."""
    cached = getattr(sf, "_env_reads", None)
    if cached is not None:
        return list(cached)
    out: List[EnvRead] = []
    if sf.tree is None:
        return out
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            name = sf.canonical(node.func)
            if name in ("os.environ.get", "os.getenv", "os.environ.__getitem__"):
                key = None
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    key = node.args[0].value
                out.append(EnvRead(key, node))
        elif isinstance(node, ast.Subscript):
            # Load context only: os.environ["K"] = "1" is a WRITE, not a
            # read — flagging it as a stale-read would be a false positive.
            if sf.canonical(node.value) == "os.environ" and \
                    isinstance(node.ctx, ast.Load):
                key = None
                sl = node.slice
                if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                    key = sl.value
                out.append(EnvRead(key, node))
    sf._env_reads = tuple(out)
    return out


@dataclasses.dataclass(frozen=True)
class LadderRung:
    """One guard-ladder rung, as extracted from the AST of the module
    defining ``DEFAULT_LADDER`` (no import of serve/ needed)."""

    name: str
    env_var: Optional[str]
    cfg_field: Optional[str]


class Project:
    """The full analyzed file set plus the injected registries.

    ``knobs`` / ``kernel_entries`` default to the real registry
    (:mod:`raft_stereo_tpu_torch.analysis.knobs`); tests inject fixture
    registries to exercise drift findings without touching the tree.
    """

    _helpers: Optional[Dict[str, "EnvHelper"]] = None
    _by_tail: Optional[Dict[str, List["EnvHelper"]]] = None

    def __init__(self, files: Sequence[SourceFile], *,
                 knobs: Optional[Sequence[str]] = None,
                 serve_knobs: Optional[Sequence[str]] = None,
                 kernel_entries: Optional[Dict] = None):
        from raft_stereo_tpu_torch.analysis import knobs as knobs_mod
        self.files = list(files)
        self.knobs: Tuple[str, ...] = tuple(
            knobs if knobs is not None else knobs_mod.ENV_KNOBS)
        #: Host/serving-side registries (SERVE_ENV_KNOBS + HOST_ENV_KNOBS):
        #: GL002's scan over the host modules accepts a RAFT_* read that
        #: appears in ANY registry — the registries differ in what they
        #: imply (cache-key membership vs documented host knob), not in
        #: lint visibility.
        self.serve_knobs: Tuple[str, ...] = tuple(
            serve_knobs if serve_knobs is not None
            else knobs_mod.SERVE_ENV_KNOBS + knobs_mod.HOST_ENV_KNOBS)
        self._helper_calls: Dict[str, List] = {}
        self.kernel_entries = (dict(kernel_entries) if kernel_entries
                               is not None else
                               dict(knobs_mod.KERNEL_ENTRY_POINTS))

    # -- cross-file lookups -----------------------------------------------

    def ladder(self) -> Optional[List[LadderRung]]:
        """Rungs of the first ``DEFAULT_LADDER = (FastPath(...), ...)``
        assignment found in the file set; None when absent (the
        corresponding GL006 cross-checks are then skipped)."""
        for sf in self.files:
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target]
                           if isinstance(node, ast.AnnAssign) else [])
                if not any(isinstance(t, ast.Name) and
                           t.id == "DEFAULT_LADDER" for t in targets):
                    continue
                if node.value is None:
                    continue
                if not isinstance(node.value, (ast.Tuple, ast.List)):
                    continue
                rungs = []
                for el in node.value.elts:
                    if not (isinstance(el, ast.Call) and
                            sf.canonical(el.func).endswith("FastPath")):
                        continue
                    kw = {k.arg: k.value for k in el.keywords}

                    def const(key):
                        v = kw.get(key)
                        return v.value if isinstance(v, ast.Constant) \
                            else None
                    if const("name"):
                        rungs.append(LadderRung(const("name"),
                                                const("env_var"),
                                                const("cfg_field")))
                if rungs:
                    return rungs
        return None

    def config_fields(self, class_name: str = "RAFTStereoConfig"
                      ) -> Optional[List[str]]:
        """Field names of the named dataclass, from its AST (annotated
        class-body assignments); None when the class isn't in the set."""
        for sf in self.files:
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.ClassDef) and \
                        node.name == class_name:
                    return [st.target.id for st in node.body
                            if isinstance(st, ast.AnnAssign) and
                            isinstance(st.target, ast.Name)]
        return None

    def find(self, suffix: str) -> Optional[SourceFile]:
        """Path-segment-bounded suffix lookup ('corr/reg_cuda.py' does
        not match 'xcorr/reg_cuda.py')."""
        for sf in self.files:
            if sf.relpath == suffix or sf.relpath.endswith("/" + suffix):
                return sf
        return None

    # -- switch helpers -----------------------------------------------------

    def env_helpers(self) -> Dict[str, "EnvHelper"]:
        """Every module-level function whose body reads the environment,
        keyed by its dotted name (``raft_stereo_tpu_torch.config.
        fuse_iter_on``): the literal keys it reads, directly, through a
        same-module helper that reads the key it is given
        (``_switch_on("RAFT_FUSE_ITER")``), or through another helper of the
        same module.  Built once, from the ASTs."""
        if self._helpers is None:
            self._helpers = _scan_env_helpers(self.files)
        return self._helpers

    def resolve_helper(self, sf: SourceFile, call: ast.Call
                       ) -> Optional["EnvHelper"]:
        """The env helper ``call`` calls: a same-module function by its
        bare name, or an imported one by its alias-resolved dotted name."""
        helpers = self.env_helpers()
        name = sf.canonical(call.func)
        if not name:
            return None
        if "." not in name:
            return helpers.get(f"{module_dotted(sf.relpath)}.{name}")
        if self._by_tail is None:
            self._by_tail = {}
            for dotted, helper in helpers.items():
                self._by_tail.setdefault(dotted.rsplit(".", 1)[-1],
                                         []).append(helper)
        for helper in self._by_tail.get(name.rsplit(".", 1)[-1], ()):
            # Either side may carry more leading package segments (the
            # analysis base, a relative import).
            if name == helper.dotted or name.endswith("." + helper.dotted) \
                    or helper.dotted.endswith("." + name):
                return helper
        return None

    def _calls(self, sf: SourceFile) -> List[Tuple[ast.Call, "EnvHelper"]]:
        """Every call in ``sf`` that reaches an env helper, with it."""
        if sf.relpath not in self._helper_calls:
            out = []
            if sf.tree is not None:
                for node in ast.walk(sf.tree):
                    if isinstance(node, ast.Call):
                        helper = self.resolve_helper(sf, node)
                        if helper is not None:
                            out.append((node, helper))
            self._helper_calls[sf.relpath] = out
        return self._helper_calls[sf.relpath]

    def env_reads(self, sf: SourceFile) -> List["EnvRead"]:
        """:func:`env_reads` plus the reads a call makes through a helper
        that reads the key it is given (``_switch_on("RAFT_X")``), keyed by
        the call's literal argument and placed at the call."""
        out = env_reads(sf)
        for node, helper in self._calls(sf):
            if helper.forwards is not None and \
                    len(node.args) > helper.forwards:
                arg = node.args[helper.forwards]
                key = arg.value if isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str) else None
                out.append(EnvRead(key, node))
        return out

    def helper_calls(self, sf: SourceFile
                     ) -> List[Tuple[ast.Call, "EnvHelper"]]:
        """Calls in ``sf`` to helpers whose own body fixes the keys read
        (``fuse_iter_on()``), with the helper."""
        return [(n, h) for n, h in self._calls(sf) if h.keys]

    def keys_consulted(self, sf: SourceFile) -> Set[str]:
        """Every literal env key ``sf`` reads: directly, through a
        forwarding helper, or by calling a helper that reads it."""
        keys = {r.key for r in self.env_reads(sf) if r.key is not None}
        for _, helper in self.helper_calls(sf):
            keys |= helper.keys
        return keys


def module_dotted(relpath: str) -> str:
    """``raft_stereo_tpu_torch/config.py`` -> ``raft_stereo_tpu_torch.config``."""
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    if mod.endswith("/__init__"):
        mod = mod[:-len("/__init__")]
    return mod.replace("/", ".")


@dataclasses.dataclass(frozen=True)
class EnvHelper:
    """A module-level function that reads the environment.

    keys: the literal keys its body reads (directly or through helpers of
        its own module).
    forwards: the index of the parameter whose value it reads as a key
        (``_switch_on(name)``), else None.
    """

    dotted: str
    keys: frozenset
    forwards: Optional[int] = None


def _scan_env_helpers(files: Sequence[SourceFile]) -> Dict[str, EnvHelper]:
    out: Dict[str, EnvHelper] = {}
    for sf in files:
        if sf.tree is None:
            continue
        mod = module_dotted(sf.relpath)
        defs = {n.name: n for n in sf.tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if not defs:
            continue
        keys: Dict[str, Set[str]] = {name: set() for name in defs}
        forwards: Dict[str, int] = {}
        for read in env_reads(sf):
            fn = next((a for a in ancestors(read.node) if a in
                       defs.values() and parent(a) is sf.tree), None)
            if fn is None:
                continue
            if read.key is not None:
                keys[fn.name].add(read.key)
                continue
            params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
            arg = (read.node.args[0] if isinstance(read.node, ast.Call)
                   and read.node.args else
                   read.node.slice if isinstance(read.node, ast.Subscript)
                   else None)
            if isinstance(arg, ast.Name) and arg.id in params:
                forwards[fn.name] = params.index(arg.id)
        # Same-module calls: a literal handed to a forwarder, or a call of
        # another helper, adds that helper's keys (to a fixed point).
        changed = True
        while changed:
            changed = False
            for name, fn in defs.items():
                for node in ast.walk(fn):
                    if not (isinstance(node, ast.Call) and
                            isinstance(node.func, ast.Name) and
                            node.func.id in defs and node.func.id != name):
                        continue
                    callee = node.func.id
                    add = set(keys[callee])
                    idx = forwards.get(callee)
                    if idx is not None and len(node.args) > idx and \
                            isinstance(node.args[idx], ast.Constant) and \
                            isinstance(node.args[idx].value, str):
                        add.add(node.args[idx].value)
                    if not add <= keys[name]:
                        keys[name] |= add
                        changed = True
        for name in defs:
            if keys[name] or name in forwards:
                out[f"{mod}.{name}"] = EnvHelper(f"{mod}.{name}",
                                                 frozenset(keys[name]),
                                                 forwards.get(name))
    return out




@dataclasses.dataclass
class Report:
    findings: List[Finding]          # unsuppressed — these fail the build
    suppressed: List[Finding]
    files_analyzed: int
    #: Programs traced by graftverify (``--trace``); 0 for AST-only runs.
    entries_traced: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def merged(self, other: "Report") -> "Report":
        """Fold another report in (the ``--trace`` stage merges the GV
        report into the AST one — a single artifact, a single verdict)."""
        return Report(self.findings + other.findings,
                      self.suppressed + other.suppressed,
                      self.files_analyzed + other.files_analyzed,
                      self.entries_traced + other.entries_traced)

    def render_text(self, show_suppressed: bool = False) -> str:
        out = [f.render() for f in sorted(
            self.findings, key=lambda f: (f.path, f.line, f.code))]
        if show_suppressed:
            out += [f.render() for f in sorted(
                self.suppressed, key=lambda f: (f.path, f.line, f.code))]
        counts: Dict[str, int] = {}
        for f in self.findings:
            counts[f.code] = counts.get(f.code, 0) + 1
        summary = ", ".join(f"{c}: {n}" for c, n in sorted(counts.items()))
        out.append(
            f"graftlint: {len(self.findings)} finding(s)"
            + (f" [{summary}]" if summary else "")
            + f", {len(self.suppressed)} suppressed, "
            f"{self.files_analyzed} file(s) analyzed"
            + (f", {self.entries_traced} program(s) traced"
               if self.entries_traced else ""))
        return "\n".join(out)

    def render_json(self) -> str:
        return json.dumps({
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "suppressed": [dataclasses.asdict(f) for f in self.suppressed],
            "files_analyzed": self.files_analyzed,
            "entries_traced": self.entries_traced,
            "ok": self.ok,
        }, indent=2, sort_keys=True)


# -- file collection -------------------------------------------------------

#: Directory basenames never descended into.
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build", "dist"}


def collect_files(roots: Sequence[str], base: Optional[str] = None
                  ) -> List[SourceFile]:
    """All ``.py`` files under ``roots`` (files accepted verbatim), with
    relpaths relative to ``base`` (default: the common parent)."""
    paths: List[str] = []
    for root in roots:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            paths.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            paths.extend(os.path.join(dirpath, f)
                         for f in sorted(filenames) if f.endswith(".py"))
    base = os.path.abspath(base) if base else (
        os.path.commonpath([os.path.dirname(p) if os.path.isfile(p) else p
                            for p in map(os.path.abspath, roots)])
        if roots else os.getcwd())
    out = []
    for p in paths:
        with open(p, "r", encoding="utf-8") as fh:
            text = fh.read()
        rel = os.path.relpath(p, base)
        out.append(SourceFile(p, rel.replace(os.sep, "/"), text))
    return out


def git_changed_files(repo_root: str) -> Set[str]:
    """Absolute paths of files changed vs HEAD (staged, unstaged and
    untracked) — the ``--changed-only`` report filter."""
    # -z: NUL-separated, unquoted paths — the line-oriented form C-quotes
    # names with spaces/non-ASCII, which would never match an abspath.
    res = subprocess.run(
        ["git", "status", "--porcelain=v1", "-z", "-uall", "--no-renames"],
        cwd=repo_root, capture_output=True, text=True, check=True)
    out: Set[str] = set()
    for entry in res.stdout.split("\0"):
        if len(entry) > 3:
            out.add(os.path.abspath(os.path.join(repo_root, entry[3:])))
    return out


# -- runner ----------------------------------------------------------------

def run_checkers(project: Project, checkers: Optional[Sequence] = None, *,
                 meta_code: str = META_CODE,
                 emit_file_meta: bool = True,
                 stale_prefix: Optional[str] = "GL") -> Report:
    """Run ``checkers`` (default: the full AST registry) over ``project``
    and fold suppressions into the verdict.

    meta_code: code for this stage's meta findings (GL000 for the AST
        stage, GC200 for the concurrency stage).
    emit_file_meta: emit parse errors and reasonless-suppression findings.
        True for whichever stage runs first over a project; the
        concurrency stage passes False when merging into an AST report so
        the same broken suppression is not reported twice.
    stale_prefix: suppressions whose codes ALL carry this prefix and that
        suppressed nothing in this run are reported as stale meta
        findings (the GL000/GC200 rot guard); None disables the check
        (used when running a checker subset, where "unused" is
        meaningless).
    """
    if checkers is None:
        from raft_stereo_tpu_torch.analysis.checkers import ALL_CHECKERS
        checkers = [c() for c in ALL_CHECKERS]
    raw: List[Finding] = []
    by_rel = {sf.relpath: sf for sf in project.files}
    if emit_file_meta:
        for sf in project.files:
            if sf.parse_error is not None:
                raw.append(Finding(
                    meta_code, f"file does not parse: {sf.parse_error.msg}",
                    sf.relpath, sf.parse_error.lineno or 1))
    for checker in checkers:
        raw.extend(checker.check_project(project))
    # Malformed suppressions are findings in their own right.
    if emit_file_meta:
        for sf in project.files:
            for line, sup in sorted(sf.suppressions.items()):
                if not sup.reason:
                    raw.append(Finding(
                        meta_code, "suppression without a reason — use "
                        "# graftlint: disable=XXnnn (why this is "
                        "intentional)", sf.relpath, line))
    active, suppressed = [], []
    used: Set[int] = set()  # id() of _Suppression objects that suppressed
    for f in raw:
        sf = by_rel.get(f.path)
        sup = sf.suppression_for(f.line) if sf is not None else None
        if (f.code not in META_CODES and sup is not None and sup.reason
                and f.code in sup.codes):
            used.add(id(sup))
            suppressed.append(dataclasses.replace(
                f, suppressed=True, suppress_reason=sup.reason))
        else:
            active.append(f)
    # Stale suppressions: a disable comment that no longer suppresses
    # anything must not rot silently — it reads as "this line has a
    # waived finding" when nothing is waived.
    if stale_prefix is not None:
        for sf in project.files:
            for line, sup in sorted(sf.suppressions.items()):
                if (sup.reason and id(sup) not in used and sup.codes and
                        all(c.startswith(stale_prefix) and
                            c not in META_CODES for c in sup.codes)):
                    active.append(Finding(
                        meta_code,
                        "stale suppression: "
                        f"{','.join(sup.codes)} no longer fires here — "
                        "delete the comment (or re-point it at the code "
                        "that actually fires)", sf.relpath, line))
    return Report(active, suppressed, len(project.files))


def run_analysis(roots: Sequence[str], *, base: Optional[str] = None,
                 knobs: Optional[Sequence[str]] = None,
                 serve_knobs: Optional[Sequence[str]] = None,
                 kernel_entries: Optional[Dict] = None,
                 checkers: Optional[Sequence] = None,
                 select: Optional[Sequence[str]] = None,
                 only_paths: Optional[Set[str]] = None) -> Report:
    """Analyze ``roots`` end to end.

    select: restrict to these finding codes (post-filter; GL000 always
        passes through — a broken suppression is never filterable away).
    only_paths: absolute paths whose findings are reported (the
        ``--changed-only`` filter); the full tree is still analyzed so
        cross-file context stays complete.
    """
    files = collect_files(roots, base=base)
    project = Project(files, knobs=knobs, serve_knobs=serve_knobs,
                      kernel_entries=kernel_entries)
    report = run_checkers(project, checkers=checkers)
    by_rel = {sf.relpath: sf.abspath for sf in files}

    def keep(f: Finding) -> bool:
        if select is not None and f.code not in META_CODES and \
                f.code not in select:
            return False
        if only_paths is not None and by_rel.get(f.path) not in only_paths:
            return False
        return True
    return Report([f for f in report.findings if keep(f)],
                  [f for f in report.suppressed if keep(f)],
                  report.files_analyzed)
