"""The port's graftlint (``raft_stereo_tpu_torch.analysis``): parity with
the JAX package's checkers on the same fixture sources, the torch forms of
GL005 and GL006, the switch-helper resolution, the CLI's exit codes, and
the port's own tree (zero unsuppressed findings; the graftlock comments
left to the concurrency stage, ``tests/test_torch_concurrency_analysis.py``).

Stdlib AST only on these paths: no torch program runs here.
"""

import ast
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from raft_stereo_tpu.analysis import run_analysis as jax_run_analysis
from raft_stereo_tpu.analysis.cli import main as jax_cli_main
from raft_stereo_tpu_torch.analysis import knobs
from raft_stereo_tpu_torch.analysis.cli import main as cli_main
from raft_stereo_tpu_torch.analysis.core import collect_files, run_analysis
from raft_stereo_tpu_torch.analysis.knobs import KernelEntry

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "raft_stereo_tpu_torch"


def write_tree(root: Path, files: dict) -> None:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def lint(tmp_path, files, **kw):
    write_tree(tmp_path, files)
    kw.setdefault("knobs", ("RAFT_KNOWN",))
    kw.setdefault("serve_knobs", ())
    kw.setdefault("kernel_entries", {})
    return run_analysis([str(tmp_path)], base=str(tmp_path), **kw)


def codes(report):
    return sorted(f.code for f in report.findings)


def sites(report):
    return {(f.code, f.path, f.line) for f in report.findings}


# ---------------------------------------------------------------------------
# Parity with the JAX package: GL000-GL004 on the same sources
# ---------------------------------------------------------------------------

PARITY_TREE = {
    # GL001: the import-time ENABLE constant, a cached read, a class-scope
    # read; a read inside a plain function is fine.
    "ops/switches.py": """
        import functools
        import os as _os

        ENABLE = _os.environ.get("RAFT_KNOWN", "1") != "0"

        @functools.lru_cache(maxsize=None)
        def cached():
            return _os.environ.get("RAFT_CACHED", "1")

        class Holder:
            FLAG = _os.environ["RAFT_KNOWN"]

        def at_build_time():
            return _os.environ.get("RAFT_KNOWN", "1")
    """,
    # GL002: unregistered reads in a program-shaping and in a host module;
    # a write is not a read; a registered host knob is fine.
    "corr/reader.py": """
        import os
        from os import environ

        def unregistered():
            return os.getenv("RAFT_NOT_REGISTERED")

        def via_from_import():
            return environ.get("RAFT_ALSO_UNREGISTERED")

        def write():
            os.environ["RAFT_WRITTEN"] = "1"
    """,
    "serve/host.py": """
        import os

        def host():
            return (os.environ.get("RAFT_HOST_UNKNOWN"),
                    os.environ.get("RAFT_HOST_OK"))
    """,
    # GL004: half-guarded attributes, and two locks with none in common.
    "serve/locks.py": """
        import threading

        class Session:
            def __init__(self):
                self._lock = threading.Lock()
                self._other = threading.RLock()
                self.count = 0
                self.items = []
                self.split = {}

            def add(self, x):
                with self._lock:
                    self.count += 1
                    self.items.append(x)
                    self.split["a"] = x

            def bare(self, x):
                self.count = 0
                self.items.clear()

            def elsewhere(self, x):
                with self._other:
                    self.split["b"] = x
    """,
    # GL003: a hand-enumerated fingerprint that misses a field.
    "model_cfg.py": """
        import dataclasses

        @dataclasses.dataclass
        class RAFTStereoConfig:
            corr_implementation: str = "reg"
            corr_levels: int = 4
            mixed_precision: bool = False
    """,
    "serve/fingerprint.py": """
        def config_fingerprint(cfg, env):
            return (cfg.corr_implementation, cfg.corr_levels, tuple(env))
    """,
    # Suppressions: with a reason (applies), without one (GL000 and the
    # finding stands), on the wrong code (stale: GL000).
    "ops/suppressed.py": """
        import os
        A = os.environ.get("RAFT_KNOWN")  # graftlint: disable=GL001 (fixture: on purpose)
        # graftlint: disable=GL001 (fixture: the comment line above)
        B = os.environ.get("RAFT_KNOWN")
        C = os.environ.get("RAFT_KNOWN")  # graftlint: disable=GL001
        D = os.environ.get("RAFT_KNOWN")  # graftlint: disable=GL004 (fixture: wrong code)
    """,
    # GL000: a file that does not parse.
    "ops/broken.py": "def broken(:\n",
}

_PARITY_ARGS = dict(knobs=("RAFT_KNOWN",), serve_knobs=("RAFT_HOST_OK",),
                    kernel_entries={}, select=("GL001", "GL002", "GL003", "GL004"))


def test_gl000_to_gl004_match_the_jax_package(tmp_path):
    write_tree(tmp_path, PARITY_TREE)
    port = run_analysis([str(tmp_path)], base=str(tmp_path), **_PARITY_ARGS)
    ref = jax_run_analysis([str(tmp_path)], base=str(tmp_path), **_PARITY_ARGS)
    assert sites(port) == sites(ref)
    assert {(f.code, f.path, f.line) for f in port.suppressed} == \
        {(f.code, f.path, f.line) for f in ref.suppressed}
    # The fixture reaches every checker of the set, and the meta code.
    assert {f.code for f in port.findings} == {"GL000", "GL001", "GL002", "GL003", "GL004"}
    assert len(port.suppressed) == 2


@pytest.mark.parametrize("argv", [
    ["--trace-geometry", "small"],
    ["--trace-registry", "nowhere.py"],
    ["--write-manifest"],
    ["--no-such-flag"],
    ["/no/such/path/anywhere"],
], ids=["geometry-without-trace", "registry-without-trace", "manifest", "unknown-flag",
        "missing-path"])
def test_cli_usage_errors_exit_like_the_jax_cli(argv, capsys):
    def rc(main):
        try:
            return main(list(argv))
        except SystemExit as e:  # argparse's own refusals
            return e.code
    assert rc(cli_main) == rc(jax_cli_main) == 2
    capsys.readouterr()


@pytest.mark.parametrize("argv", [["--concurrency"], ["--concurrency", "--write-manifest"]])
def test_cli_refuses_the_unported_concurrency_stage(argv, capsys, tmp_path):
    # The flags were refused while graftlock was unported; now they run the
    # stage: over the port against its own manifest (exit 0), and with
    # --write-manifest over a fixture tree, whose manifest it writes there.
    if "--write-manifest" in argv:
        write_tree(tmp_path, {"locks.py": """
            import threading

            LOCK_A = threading.Lock()
            LOCK_B = threading.Lock()

            def ab():
                with LOCK_A:
                    with LOCK_B:
                        pass
        """})
        assert cli_main(argv + [str(tmp_path)]) == 0
        assert "`locks.py::LOCK_A` -> `locks.py::LOCK_B`" in \
            (tmp_path / "LOCK_ORDER.md").read_text()
    else:
        assert cli_main(argv) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# GL001 / GL002 through the port's switch helpers
# ---------------------------------------------------------------------------

HELPERS = {
    "config.py": """
        import os

        def _switch_on(name):
            return os.environ.get(name, "1") not in ("0", "off")

        def fuse_on():
            return _switch_on("RAFT_KNOWN")

        def both_on():
            return fuse_on() and _switch_on("RAFT_UNREGISTERED_HELPER")
    """,
}


def test_helper_keys_are_read_from_the_helpers_bodies(tmp_path):
    from raft_stereo_tpu_torch.analysis.core import Project
    write_tree(tmp_path, HELPERS)
    project = Project(collect_files([str(tmp_path)], base=str(tmp_path)))
    helpers = project.env_helpers()
    assert helpers["config._switch_on"].forwards == 0
    assert helpers["config.fuse_on"].keys == {"RAFT_KNOWN"}
    assert helpers["config.both_on"].keys == {"RAFT_KNOWN", "RAFT_UNREGISTERED_HELPER"}


def test_gl002_sees_a_read_through_a_forwarding_helper(tmp_path):
    rep = lint(tmp_path, HELPERS)
    assert [(f.code, f.path) for f in rep.findings] == [("GL002", "config.py")]
    assert "RAFT_UNREGISTERED_HELPER" in rep.findings[0].message


def test_gl001_flags_a_helper_called_at_import_or_in_a_cache(tmp_path):
    rep = lint(tmp_path, {**HELPERS, "ops/user.py": """
        import functools
        from config import fuse_on

        AT_IMPORT = fuse_on()

        @functools.lru_cache(maxsize=None)
        def cached():
            return fuse_on()

        def at_build_time():
            return fuse_on()

        if __name__ == "__main__":
            fuse_on()
    """}, select=("GL001",))
    assert sorted((f.path, f.line) for f in rep.findings) == [
        ("ops/user.py", 5), ("ops/user.py", 9)]
    assert all("config.fuse_on()" in f.message for f in rep.findings)


# ---------------------------------------------------------------------------
# GL005 in torch's terms
# ---------------------------------------------------------------------------

def test_gl005_flags_impure_calls_in_captured_and_rerun_code(tmp_path):
    rep = lint(tmp_path, {"serve/programs.py": """
        import os
        import time

        import torch
        from torch.utils.checkpoint import checkpoint

        STATS = []

        def build_program(kind, model, iters):
            def fwd(x):
                t = time.time()
                return model(x), t
            def helper(x):
                return time.time()     # not returned: never captured
            if kind == "full":
                return fwd
            return lambda x: (model(x), os.environ.get("RAFT_KNOWN"))

        def capture(graph, fn, x):
            with torch.cuda.graph(graph):
                out = fn(x)
                STATS.append(time.perf_counter())
            return out

        def train(model, x):
            def one_iteration(y):
                return model(y) * time.monotonic()
            return checkpoint(one_iteration, x, use_reentrant=False)
    """}, select=("GL005",))
    lines = sorted(f.line for f in rep.findings)
    # time.time() in fwd; the lambda's env read; the captured block's
    # perf_counter() and its mutation of a module-level list; the
    # checkpointed function's monotonic().
    assert lines == [12, 18, 23, 23, 28], [f.render() for f in rep.findings]
    assert all("replayed via" in f.message for f in rep.findings)


# ---------------------------------------------------------------------------
# GL006 over kernels.entry
# ---------------------------------------------------------------------------

GL006_BASE = {
    "config.py": HELPERS["config.py"],
    "model_cfg.py": PARITY_TREE["model_cfg.py"],
    "serve/guard.py": """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class FastPath:
            name: str
            env_var: str = None
            cfg_field: str = None

        DEFAULT_LADDER = (
            FastPath(name="my_kernel", env_var="RAFT_KNOWN"),
            FastPath(name="cfg_rung", cfg_field="corr_implementation"),
            FastPath(name="bad_cfg", cfg_field="no_such_field"),
        )
    """,
    "ops/mykern.py": """
        from pkg import kernels
        from config import fuse_on

        def launch(x):
            if not fuse_on():
                return x
            fn = kernels.entry("mykern")
            return fn(x)

        def serial(x):
            return kernels.entry("serial_kern")(x)
    """,
    "ops/gated.py": """
        from pkg import kernels

        def launch(x):
            return kernels.entry("gated")(x)
    """,
    "models/model.py": """
        from config import fuse_on
        from ops import gated

        def forward(x):
            return gated.launch(x) if fuse_on() else x
    """,
}


def _gl006(tmp_path, entries, extra=None):
    rep = lint(tmp_path, {**GL006_BASE, **(extra or {})}, kernel_entries=entries,
               knobs=("RAFT_KNOWN", "RAFT_UNREGISTERED_HELPER"), select=("GL006",))
    return sorted((f.path, f.message.split(" — ")[0]) for f in rep.findings)


def test_gl006_clean_when_every_site_is_covered(tmp_path):
    entries = {
        "ops/mykern.py": KernelEntry(rungs=("my_kernel", "cfg_rung"),
                                     exempt_sites=(("serial_kern", "fixture: no rung"),)),
        "ops/gated.py": KernelEntry(rungs=("my_kernel",), gates=("models/model.py",)),
    }
    assert _gl006(tmp_path, entries) == []


def test_gl006_flags_a_launch_module_without_an_entry(tmp_path):
    found = _gl006(tmp_path, {"ops/mykern.py": KernelEntry(rungs=("my_kernel",),
                                                           exempt_sites=(("serial_kern",
                                                                          "fixture"),))})
    assert found == [("ops/gated.py", "module launches hand-written kernels "
                      "(kernels.entry) but has no entry in raft_stereo_tpu_torch/analysis/"
                      "knobs.py KERNEL_ENTRY_POINTS")]


def test_gl006_flags_an_unknown_rung_and_a_missing_config_field(tmp_path):
    found = _gl006(tmp_path, {
        "ops/mykern.py": KernelEntry(rungs=("no_such_rung", "bad_cfg"),
                                     exempt_sites=(("serial_kern", "fixture"),)),
        "ops/gated.py": KernelEntry(rungs=("my_kernel",), gates=("models/model.py",))})
    assert [m for _, m in found] == [
        "declared ladder rung 'no_such_rung' does not exist in DEFAULT_LADDER "
        "(serve/guard.py)",
        "rung 'bad_cfg' config switch 'no_such_field' is not a field of the model config"]


def test_gl006_flags_a_switch_consulted_nowhere(tmp_path):
    # Without its gate, ops/gated.py never consults RAFT_KNOWN.
    found = _gl006(tmp_path, {
        "ops/mykern.py": KernelEntry(rungs=("my_kernel",),
                                     exempt_sites=(("serial_kern", "fixture"),)),
        "ops/gated.py": KernelEntry(rungs=("my_kernel",))})
    assert found == [("ops/gated.py", "rung 'my_kernel' kill switch 'RAFT_KNOWN' is never "
                      "read in this module")]


def test_gl006_flags_stale_entries_and_exempt_sites(tmp_path):
    found = _gl006(tmp_path, {
        "ops/mykern.py": KernelEntry(rungs=("my_kernel",),
                                     exempt_sites=(("serial_kern", "fixture"),
                                                   ("gone_kern", "fixture"))),
        "ops/gated.py": KernelEntry(rungs=("my_kernel",), gates=("models/model.py",)),
        "models/model.py": KernelEntry(rungs=("my_kernel",))})
    assert found == [
        ("models/model.py", "stale registry entry: models/model.py no longer calls "
                            "kernels.entry"),
        ("ops/mykern.py", "stale exempt site 'gone_kern': this module makes no "
                          "kernels.entry('gone_kern') call")]


# ---------------------------------------------------------------------------
# The port's own tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_report():
    return run_analysis([str(PORT)], base=str(REPO))


def test_the_port_has_no_unsuppressed_findings(port_report):
    assert port_report.findings == [], "\n".join(f.render() for f in port_report.findings)
    assert port_report.files_analyzed > 90


def test_the_graftlock_comments_are_neither_findings_nor_applied(port_report):
    files = collect_files([str(PORT)], base=str(REPO))
    gc = [(sf.relpath, line) for sf in files for line, sup in sf.suppressions.items()
          if all(c.startswith("GC") for c in sup.codes)]
    assert len(gc) == 21 and all(sup.reason for sf in files
                                for sup in sf.suppressions.values())
    assert not any(f.code.startswith("GC") for f in port_report.suppressed)
    assert not any(f.path == p and f.line == ln for f in port_report.findings
                   for p, ln in gc)


def test_every_kernel_launch_module_is_registered():
    # The registry covers exactly the modules that call kernels.entry(...).
    launching = set()
    for path in PORT.rglob("*.py"):
        if "analysis" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        if any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and
               n.func.attr == "entry" and isinstance(n.func.value, ast.Name) and
               n.func.value.id == "kernels" for n in ast.walk(tree)):
            launching.add(path.relative_to(PORT).as_posix())
    assert launching == set(knobs.KERNEL_ENTRY_POINTS)
    # No launch site is exempt: the fused_update rung covers the serial loop.
    assert not any(e.exempt_sites for e in knobs.KERNEL_ENTRY_POINTS.values())
    for mod in ("ops/stream.py", "ops/resident.py"):
        assert "fused_update" in knobs.KERNEL_ENTRY_POINTS[mod].rungs


def test_cli_over_the_port_exits_zero(capsys):
    assert cli_main([]) == 0
    assert "graftlint: 0 finding(s)" in capsys.readouterr().out


def test_analysis_top_level_imports_no_torch_and_no_jax():
    # The linter's modules stay stdlib-only; only trace/ imports torch.
    for path in (PORT / "analysis").rglob("*.py"):
        if "trace" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("torch", "numpy", "jax", "raft_stereo_tpu"), \
                    (path, name)
    code = ("import sys; sys.modules['jax'] = None; sys.modules['raft_stereo_tpu'] = None\n"
            "import raft_stereo_tpu_torch.analysis.cli, raft_stereo_tpu_torch.analysis.trace, "
            "raft_stereo_tpu_torch.analysis.trace.graphs, "
            "raft_stereo_tpu_torch.analysis.trace.checkers\nprint('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_regrow_extent_takes_the_mesh_lock():
    """The GL004 repair in serve/session.py: ``_regrow_extent`` mutates the
    live mesh under the (re-entrant) mesh lock itself, so a caller that does
    not hold it waits for one that does."""
    from raft_stereo_tpu_torch.obs.metrics import MetricsRegistry
    from raft_stereo_tpu_torch.serve.session import InferenceSession
    stub = type("Stub", (), {})()
    stub._mesh_lock = threading.RLock()
    stub._mesh_devices = ["cpu", "cpu"]
    stub._quarantined = {0, 1}
    stub._mesh_epoch = 0
    stub._mesh_live, stub._mesh_n = (0, 1), 2
    stub.registry = MetricsRegistry()
    held, done = threading.Event(), []

    def holder():
        with stub._mesh_lock:
            held.set()
            time.sleep(0.3)
            done.append(("holder", stub._mesh_epoch))

    t = threading.Thread(target=holder)
    t.start()
    held.wait()
    assert InferenceSession._regrow_extent(stub) == 0
    done.append(("regrow", stub._mesh_epoch))
    t.join()
    assert done == [("holder", 0), ("regrow", 1)]
    assert stub._mesh_live is None and stub._mesh_n == 1
    with stub._mesh_lock:  # re-entrant: a caller holding the lock goes on
        assert InferenceSession._regrow_extent(stub) == 0 and stub._mesh_epoch == 2
