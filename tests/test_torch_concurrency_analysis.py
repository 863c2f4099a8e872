"""The port's graftlock (``raft_stereo_tpu_torch.analysis.concurrency``):
each GC checker on its violating fixture and its corrected twin, the same
codes at the same lines as the JAX package's checkers on every fixture
source, suppression and stale-meta semantics, the CLI's manifest ceremony
over the port's own ``raft_stereo_tpu_torch/LOCK_ORDER.md``, the model's
port idioms (the capture gate, ``_held``, the program call, nested defs),
and the runtime witness: its unit cases, and the tiny fault storm served
under it on the CPU with no edge outside the static graph.

The static half is stdlib only and runs with torch and jax blocked.
"""

import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from raft_stereo_tpu.analysis.concurrency import \
    run_concurrency_analysis as jax_run_concurrency_analysis
from raft_stereo_tpu_torch.analysis.cli import main as cli_main
from raft_stereo_tpu_torch.analysis.concurrency import (run_concurrency_analysis,
                                                        write_lock_order_manifest)
from raft_stereo_tpu_torch.analysis.concurrency.graph import build_lock_graph
from raft_stereo_tpu_torch.analysis.concurrency.model import LockModel
from raft_stereo_tpu_torch.analysis.concurrency.witness import (LockWitness, package_model,
                                                                unexplained_edges)
from raft_stereo_tpu_torch.analysis.core import Project, collect_files

pytestmark = pytest.mark.concurrency_analysis

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "raft_stereo_tpu_torch"
MANIFEST = PORT / "LOCK_ORDER.md"


def write_tree(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def gc_lint(tmp_path, files, **kw):
    """The GC suite over ``files`` written under ``tmp_path``; manifest
    checking off unless a test opts in (a fixture tree has none)."""
    write_tree(tmp_path, files)
    kw.setdefault("check_manifest", False)
    return run_concurrency_analysis([str(tmp_path)], base=str(tmp_path), **kw)


def model_of(tmp_path, files):
    write_tree(tmp_path, files)
    return LockModel(Project(collect_files([str(tmp_path)], base=str(tmp_path))))


def codes(report):
    return sorted(f.code for f in report.findings)


def sites(findings):
    return sorted((f.code, f.path, f.line) for f in findings)


# ---------------------------------------------------------------------------
# Fixture sources: (file, source, the codes the port reports), the JAX
# package's battery (tests/test_concurrency_analysis.py) case for case.
# ---------------------------------------------------------------------------

_CYCLE = """
    import threading

    LOCK_A = threading.Lock()
    LOCK_B = threading.Lock()

    def ab():
        with LOCK_A:
            with LOCK_B:
                pass

    def ba():
        with LOCK_B:
            with LOCK_A:
                pass
"""

_ACYCLIC = """
    import threading

    LOCK_A = threading.Lock()
    LOCK_B = threading.Lock()

    def ab():
        with LOCK_A:
            with LOCK_B:
                pass

    def ab_again():
        with LOCK_A:
            with LOCK_B:
                pass
"""

_LOCKED_BASE = """
    import threading

    class S:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0

        def _bump_locked(self):
            self.count += 1
"""

FIXTURES = {
    "gc201_cycle": ("locks.py", _CYCLE, ["GC201"]),
    "gc201_acyclic": ("locks.py", _ACYCLIC, []),
    "gc202_abandoned": ("serve/svc.py", """
        from concurrent.futures import Future

        def submit():
            fut = Future()
            compute = 1
    """, ["GC202"]),
    "gc202_unregistered_sink": ("serve/svc.py", """
        from concurrent.futures import Future

        WAITERS = []

        def submit():
            fut = Future()
            WAITERS.append(fut)
    """, ["GC202"]),
    "gc202_risky_window": ("serve/svc.py", """
        from concurrent.futures import Future

        WAITERS = []

        def submit(work):
            fut = Future()
            WAITERS.append(fut)
            work()
            fut.set_result(1)
            return fut
    """, ["GC202"]),
    "gc202_corrected": ("serve/svc.py", """
        from concurrent.futures import Future

        WAITERS = []

        def factory():
            fut = Future()
            return fut

        def drained(q):
            fut = Future()
            q.put_nowait((0, fut))
            return fut

        def protected(work):
            fut = Future()
            WAITERS.append(fut)
            try:
                work()
                fut.set_result(1)
            except Exception as e:
                fut.set_exception(e)
            return fut
    """, []),
    "gc202_out_of_scope": ("util/svc.py", """
        from concurrent.futures import Future

        def submit():
            fut = Future()
            compute = 1
    """, []),
    "gc203_sleep": ("svc.py", """
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def poll(self):
                with self._lock:
                    time.sleep(0.1)
    """, ["GC203"]),
    "gc203_corrected": ("svc.py", """
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def poll(self):
                with self._lock:
                    n = 1
                time.sleep(0.1)
    """, []),
    "gc203_cv_wait_alone": ("svc.py", """
        import threading

        class S:
            def __init__(self):
                self._cv = threading.Condition()

            def park(self):
                with self._cv:
                    self._cv.wait()
    """, []),
    "gc203_cv_wait_under_other": ("svc2.py", """
        import threading

        class S:
            def __init__(self):
                self._cv = threading.Condition()
                self._lock = threading.Lock()

            def park(self):
                with self._lock:
                    with self._cv:
                        self._cv.wait()
    """, ["GC203"]),
    "gc203_propagated": ("svc.py", """
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def tick(self):
                with self._lock:
                    self._drain()

            def _drain(self):
                time.sleep(0.1)
    """, ["GC203"]),
    # The port's registry: the card's host waits under a lock.
    "gc203_synchronize": ("svc.py", """
        import threading
        import torch
        import torch.distributed as dist

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def drain(self):
                with self._lock:
                    torch.cuda.synchronize()
                    dist.barrier()
    """, ["GC203", "GC203"]),
    "gc204_io": ("rec.py", """
        import json
        import threading

        class R:
            def __init__(self):
                self._lock = threading.Lock()
                self.doc = {}

            def dump(self, path):
                with self._lock:
                    with open(path, "w") as f:
                        json.dump(self.doc, f)
    """, ["GC204", "GC204"]),
    "gc204_snapshot": ("rec.py", """
        import json
        import threading

        class R:
            def __init__(self):
                self._lock = threading.Lock()
                self.doc = {}

            def dump(self, path):
                with self._lock:
                    snap = dict(self.doc)
                with open(path, "w") as f:
                    json.dump(snap, f)
    """, []),
    "gc204_sink_lock": ("rec.py", """
        import json
        import threading

        class R:
            def __init__(self):
                self._sink_lock = threading.Lock()
                self.doc = {}

            def dump(self, path):
                with self._sink_lock:
                    with open(path, "w") as f:
                        json.dump(self.doc, f)
    """, []),
    "gc205_unlocked_call": ("svc.py", _LOCKED_BASE + """
        def bump(self):
            self._bump_locked()
    """, ["GC205"]),
    "gc205_locked_call": ("svc.py", _LOCKED_BASE + """
        def _sweep_locked(self):
            self._bump_locked()

        def bump(self):
            with self._lock:
                self._bump_locked()
    """, []),
    "gc205_guarded_attr": ("svc.py", _LOCKED_BASE + """
        def bump(self):
            with self._lock:
                self._bump_locked()

        def reset(self):
            self.count = 0
    """, ["GC205"]),
    "gc205_guarded_attr_locked": ("svc.py", _LOCKED_BASE + """
        def bump(self):
            with self._lock:
                self._bump_locked()

        def reset(self):
            with self._lock:
                self.count = 0
    """, []),
    "gc206_fire_and_forget": ("serve/w.py", """
        import threading

        def kick(fn):
            threading.Thread(target=fn, daemon=True).start()
    """, ["GC206"]),
    "gc206_attr_no_join": ("obs/w.py", """
        import threading

        class W:
            def start(self, fn):
                self._t = threading.Thread(target=fn)
                self._t.start()
    """, ["GC206"]),
    "gc206_joined": ("serve/w.py", """
        import threading

        class W:
            def start(self, fn):
                self._t = threading.Thread(target=fn)
                self._t.start()

            def stop(self):
                t = self._t
                if t is not None:
                    t.join(timeout=5.0)

        def scoped(fn):
            t = threading.Thread(target=fn)
            t.start()
            t.join()

        def handed_off(fn, reaper):
            t = threading.Thread(target=fn)
            t.start()
            reaper.adopt(t)
    """, []),
    "gc206_out_of_scope": ("util/w.py", """
        import threading

        def kick(fn):
            threading.Thread(target=fn, daemon=True).start()
    """, []),
    "suppressed": ("svc.py", """
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def poll(self):
                with self._lock:
                    # graftlint: disable=GC203 (bounded test fixture wait)
                    time.sleep(0.1)
    """, []),
    "reasonless": ("svc.py", """
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def poll(self):
                with self._lock:
                    time.sleep(0.1)  # graftlint: disable=GC203
    """, ["GC200", "GC203"]),
    "stale": ("svc.py", """
        import time

        def poll():
            # graftlint: disable=GC203 (nothing here blocks under a lock)
            time.sleep(0.1)
    """, ["GC200"]),
}

# The port's registry adds the card's host waits; on these sources the JAX
# package's checkers (which do not know them) are not the reference.
PORT_ONLY = {"gc203_synchronize"}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_each_fixture_gives_its_codes(tmp_path, name):
    rel, src, want = FIXTURES[name]
    assert codes(gc_lint(tmp_path, {rel: src})) == want


@pytest.mark.parametrize("name", sorted(set(FIXTURES) - PORT_ONLY))
def test_gc_codes_and_lines_match_the_jax_package(tmp_path, name):
    rel, src, _ = FIXTURES[name]
    write_tree(tmp_path, {rel: src})
    kw = dict(base=str(tmp_path), check_manifest=False)
    port = run_concurrency_analysis([str(tmp_path)], **kw)
    ref = jax_run_concurrency_analysis([str(tmp_path)], **kw)
    assert sites(port.findings) == sites(ref.findings)
    assert sites(port.suppressed) == sites(ref.suppressed)


def test_finding_messages_name_what_fired(tmp_path):
    msgs = {}
    for name in ("gc201_cycle", "gc202_abandoned", "gc202_unregistered_sink",
                 "gc202_risky_window", "gc203_sleep", "gc203_propagated",
                 "gc205_unlocked_call", "gc205_guarded_attr", "gc206_fire_and_forget",
                 "gc206_attr_no_join", "stale"):
        rel, src, _ = FIXTURES[name]
        rep = gc_lint(tmp_path / name, {rel: src})
        msgs[name] = rep.findings[0].message
    assert "lock-order cycle" in msgs["gc201_cycle"]
    assert "LOCK_A" in msgs["gc201_cycle"] and "LOCK_B" in msgs["gc201_cycle"]
    assert "never resolved" in msgs["gc202_abandoned"]
    assert "unregistered sink" in msgs["gc202_unregistered_sink"]
    assert "can raise before it is resolved" in msgs["gc202_risky_window"]
    assert "time.sleep" in msgs["gc203_sleep"]
    assert "reached via" in msgs["gc203_propagated"]
    assert "no lock lexically held" in msgs["gc205_unlocked_call"]
    assert "mutated lock-free" in msgs["gc205_guarded_attr"]
    assert "fire-and-forget" in msgs["gc206_fire_and_forget"]
    assert "no join" in msgs["gc206_attr_no_join"]
    assert "stale" in msgs["stale"].lower()


def test_gc201_acyclic_twin_has_its_edge(tmp_path):
    edges = build_lock_graph(model_of(tmp_path, {"locks.py": _ACYCLIC}))
    assert ("locks.py::LOCK_A", "locks.py::LOCK_B") in edges
    assert ("locks.py::LOCK_B", "locks.py::LOCK_A") not in edges


def test_gc201_missing_manifest_is_a_finding(tmp_path):
    rep = gc_lint(tmp_path, {"locks.py": _ACYCLIC}, check_manifest=True)
    assert codes(rep) == ["GC201"]
    assert rep.findings[0].path == "LOCK_ORDER.md" and "missing" in rep.findings[0].message


def test_gc201_drift_and_regenerated_manifest(tmp_path):
    write_tree(tmp_path, {"locks.py": _ACYCLIC})
    (tmp_path / "LOCK_ORDER.md").write_text("# Lock order\n")
    rep = run_concurrency_analysis([str(tmp_path)], base=str(tmp_path))
    assert codes(rep) == ["GC201"] and "drift" in rep.findings[0].message
    write_lock_order_manifest([str(tmp_path)], base=str(tmp_path))
    first = (tmp_path / "LOCK_ORDER.md").read_bytes()
    assert b"LOCK_A" in first
    assert codes(run_concurrency_analysis([str(tmp_path)], base=str(tmp_path))) == []
    write_lock_order_manifest([str(tmp_path)], base=str(tmp_path))
    assert (tmp_path / "LOCK_ORDER.md").read_bytes() == first


def test_gc201_manifest_drift_is_unsuppressable(tmp_path):
    write_tree(tmp_path, {"locks.py": _ACYCLIC})
    (tmp_path / "LOCK_ORDER.md").write_text("# graftlint: disable=GC201 (cannot apply)\n")
    assert codes(run_concurrency_analysis([str(tmp_path)], base=str(tmp_path))) == ["GC201"]


def test_manifest_lives_in_the_analyzed_root_and_names_it_under_the_base(tmp_path):
    """A package analyzed from its repo: the manifest is the package's own
    file, reported under its path from the base (the port's layout: never
    the JAX package's root LOCK_ORDER.md)."""
    write_tree(tmp_path, {"pkg/locks.py": _ACYCLIC})
    (tmp_path / "LOCK_ORDER.md").write_text("# someone else's manifest\n")
    rep = run_concurrency_analysis([str(tmp_path / "pkg")], base=str(tmp_path))
    assert [(f.code, f.path) for f in rep.findings] == [("GC201", "pkg/LOCK_ORDER.md")]
    path = write_lock_order_manifest([str(tmp_path / "pkg")], base=str(tmp_path))
    assert path == str(tmp_path / "pkg" / "LOCK_ORDER.md")
    assert "`pkg/locks.py::LOCK_A` -> `pkg/locks.py::LOCK_B`" in Path(path).read_text()
    assert (tmp_path / "LOCK_ORDER.md").read_text() == "# someone else's manifest\n"


def test_gc_suppression_with_reason_applies(tmp_path):
    rel, src, _ = FIXTURES["suppressed"]
    rep = gc_lint(tmp_path, {rel: src})
    assert codes(rep) == [] and [f.code for f in rep.suppressed] == ["GC203"]


def test_gc_select_filters_codes(tmp_path):
    rep = gc_lint(tmp_path, {"serve/both.py": """
        import threading
        import time
        from concurrent.futures import Future

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def poll(self):
                with self._lock:
                    time.sleep(0.1)

        def submit():
            fut = Future()
            compute = 1
    """}, select=("GC202",))
    assert codes(rep) == ["GC202"]


def test_write_manifest_requires_concurrency(capsys):
    assert cli_main(["--write-manifest"]) == 2
    assert "--write-manifest requires --concurrency" in capsys.readouterr().err


def test_cli_cycle_fails_and_corrected_twin_passes(tmp_path, capsys):
    """An injected lock-order cycle fails the CLI (exit 1); the corrected
    twin with its regenerated manifest passes (exit 0)."""
    write_tree(tmp_path, {"locks.py": _CYCLE})
    assert cli_main(["--concurrency", str(tmp_path)]) == 1
    assert "lock-order cycle" in capsys.readouterr().out
    write_tree(tmp_path, {"locks.py": _ACYCLIC})
    write_lock_order_manifest([str(tmp_path)], base=str(tmp_path))
    assert cli_main(["--concurrency", str(tmp_path)]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# The model's port idioms
# ---------------------------------------------------------------------------

def test_model_resolves_the_ports_lock_idioms(tmp_path):
    """``with _held(LOCK):`` holds LOCK; ``_gate(dev).alone()`` reaches the
    gate's condition through ``_gate``'s return annotation; a call the
    registry declares (``prog.fn`` in serve/session.py) reaches
    ``kernels.entry``; a closure named like a method does not replace it."""
    edges = build_lock_graph(model_of(tmp_path, {
        "kernels.py": """
            import threading

            _lock = threading.Lock()

            def entry(name):
                with _lock:
                    return name
        """,
        "serve/session.py": """
            import contextlib
            import threading

            _ENV_LOCK = threading.Lock()

            class _CaptureGate:
                def __init__(self):
                    self._cond = threading.Condition()

                @contextlib.contextmanager
                def alone(self):
                    with self._cond:
                        pass
                    yield

            def _gate(dev) -> _CaptureGate:
                return _CaptureGate()

            @contextlib.contextmanager
            def _held(lock):
                if not lock.acquire(timeout=1.0):
                    raise TimeoutError
                try:
                    yield
                finally:
                    lock.release()

            class Program:
                def __init__(self):
                    self.lock = threading.Lock()

            class Session:
                def _probe(self):
                    def _run(i):
                        return i
                    return _run

                def _run(self, prog):
                    with prog.lock:
                        with _held(_ENV_LOCK):
                            with _gate("cuda:0").alone():
                                prog.fn()
        """}))
    s = "serve/session.py::"
    for src, dst in ((f"{s}Program.lock", f"{s}_ENV_LOCK"),
                     (f"{s}_ENV_LOCK", f"{s}_CaptureGate._cond"),
                     (f"{s}_ENV_LOCK", "kernels.py::_lock"),
                     (f"{s}Program.lock", "kernels.py::_lock")):
        assert (src, dst) in edges, (src, dst, sorted(edges))


def test_port_graph_holds_the_capture_path():
    """The port's own graph: a capture holds the program's lock, then
    ``_ENV_LOCK``, then takes the device gate and the build lock."""
    edges = build_lock_graph(package_model())
    s = "raft_stereo_tpu_torch/serve/session.py::"
    for src, dst in ((f"{s}_Program.lock", f"{s}_ENV_LOCK"),
                     (f"{s}_ENV_LOCK", f"{s}_CaptureGate._cond"),
                     (f"{s}_ENV_LOCK", f"{s}_GATES_LOCK"),
                     (f"{s}_ENV_LOCK", "raft_stereo_tpu_torch/kernels.py::_lock")):
        assert (src, dst) in edges, (src, dst)


# ---------------------------------------------------------------------------
# The live tree
# ---------------------------------------------------------------------------

def test_real_tree_concurrency_clean_without_torch_or_jax():
    """The acceptance command, with torch, jax and the JAX package blocked:
    zero unsuppressed findings and no drift from the port's manifest."""
    code = ("import sys\n"
            "for m in ('torch', 'jax', 'numpy', 'raft_stereo_tpu'): sys.modules[m] = None\n"
            "from raft_stereo_tpu_torch.analysis.cli import main\n"
            "sys.exit(main(['--concurrency', '--json', 'raft_stereo_tpu_torch']))")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    import json
    doc = json.loads(res.stdout)
    assert doc["findings"] == []


def test_committed_manifest_regeneration_is_byte_stable(tmp_path):
    out = tmp_path / "LOCK_ORDER.md"
    write_lock_order_manifest([str(PORT)], base=str(REPO), manifest_path=str(out))
    assert out.read_bytes() == MANIFEST.read_bytes()
    assert "raft_stereo_tpu_torch.analysis --concurrency" in MANIFEST.read_text()


def test_every_gc_suppression_in_the_port_is_reasoned_and_live():
    """Every GC comment in the port carries a reason and suppresses a
    finding (a stale one would be GC200 in the clean run above)."""
    rep = run_concurrency_analysis([str(PORT)], base=str(REPO))
    assert rep.findings == [], "\n".join(f.render() for f in rep.findings)
    files = collect_files([str(PORT)], base=str(REPO))
    gc = {(sf.relpath, line): sup for sf in files for line, sup in sf.suppressions.items()
          if all(c.startswith("GC") for c in sup.codes)}
    assert gc and all(sup.reason for sup in gc.values())
    used = {(f.path, f.line) for f in rep.suppressed}
    for (path, line) in gc:
        assert (path, line) in used or (path, line + 1) in used, (path, line)


# ---------------------------------------------------------------------------
# The runtime witness
# ---------------------------------------------------------------------------

WITNESS_SRC = """\
import threading

LOCK_A = threading.Lock()
LOCK_B = threading.Lock()


def in_order():
    with LOCK_A:
        with LOCK_B:
            pass
"""


def _witness_fixture(tmp_path):
    """A module whose path looks like the port's (the witness keys a lock
    on its first ``raft_stereo_tpu_torch/`` frame), whose static graph
    holds A -> B alone."""
    mod = tmp_path / "raft_stereo_tpu_torch" / "serve" / "wit.py"
    mod.parent.mkdir(parents=True)
    mod.write_text(WITNESS_SRC)
    fs = collect_files([str(tmp_path / "raft_stereo_tpu_torch")], base=str(tmp_path))
    return mod, LockModel(Project(fs))


def test_witness_in_order_acquisition_is_explained(tmp_path):
    mod, model = _witness_fixture(tmp_path)
    with LockWitness() as w:
        ns = {}
        exec(compile(mod.read_text(), str(mod), "exec"), ns)
        ns["in_order"]()
    assert w.edges
    assert unexplained_edges(w, model) == []


def test_witness_detects_out_of_order_acquisition(tmp_path):
    mod, model = _witness_fixture(tmp_path)
    with LockWitness() as w:
        ns = {}
        exec(compile(mod.read_text(), str(mod), "exec"), ns)
        with ns["LOCK_B"]:
            with ns["LOCK_A"]:
                pass
    bad = unexplained_edges(w, model)
    assert len(bad) == 1
    assert "LOCK_B" in bad[0] and "LOCK_A" in bad[0]
    assert "not in the static lock-order graph" in bad[0]


def test_witness_unpatches_threading_on_exit():
    orig_lock, orig_rlock = threading.Lock, threading.RLock
    with LockWitness():
        assert threading.Lock is not orig_lock
    assert threading.Lock is orig_lock and threading.RLock is orig_rlock


def test_witness_skips_unmapped_locks(tmp_path):
    _mod, model = _witness_fixture(tmp_path)
    with LockWitness() as w:
        a = threading.Lock()  # minted here: tests/ is not in the model
        b = threading.Lock()
        with a:
            with b:
                pass
    assert unexplained_edges(w, model) == []


def test_witness_condition_wait_keeps_stack_honest(tmp_path):
    """cv.wait() releases the condition and re-acquires it on wake: the
    witness neither deadlocks on the wrapped lock nor records an edge from
    a lock the waiter no longer holds."""
    mod = tmp_path / "raft_stereo_tpu_torch" / "serve" / "cvfix.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("import threading\n\nCV = threading.Condition()\nOTHER = threading.Lock()\n")
    fs = collect_files([str(tmp_path / "raft_stereo_tpu_torch")], base=str(tmp_path))
    model = LockModel(Project(fs))
    with LockWitness() as w:
        ns = {}
        exec(compile(mod.read_text(), str(mod), "exec"), ns)
        cv, other = ns["CV"], ns["OTHER"]
        parked, done = threading.Event(), []

        def waiter():
            with cv:
                parked.set()
                while not done:
                    cv.wait(timeout=1.0)
                assert not w._stack()[:-1]  # the condition alone is held
            with other:  # nothing held: no edge
                pass

        t = threading.Thread(target=waiter)
        t.start()
        parked.wait(5.0)
        with cv:
            done.append(1)
            cv.notify()
        t.join(timeout=5.0)
        assert not t.is_alive()
    assert w.edges == set() and unexplained_edges(w, model) == []


def test_witness_adopts_module_locks_minted_before_it_armed(tmp_path):
    """A module-level lock minted at import is wrapped in place, keyed on
    its declaration line, and put back on exit."""
    import importlib.util
    mod_path = tmp_path / "raft_stereo_tpu_torch" / "witfix_adopt.py"
    mod_path.parent.mkdir(parents=True)
    mod_path.write_text(WITNESS_SRC)
    spec = importlib.util.spec_from_file_location("raft_stereo_tpu_torch.witfix_adopt",
                                                  mod_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # LOCK_A, LOCK_B minted before the witness arms
    sys.modules[spec.name] = mod
    try:
        model = LockModel(Project(collect_files([str(tmp_path / "raft_stereo_tpu_torch")],
                                                base=str(tmp_path))))
        orig = mod.LOCK_A
        with LockWitness() as w:
            adopted = w.adopt_module_locks(model)
            mod.in_order()
            with mod.LOCK_B:
                with mod.LOCK_A:
                    pass
        assert adopted == ["raft_stereo_tpu_torch/witfix_adopt.py::LOCK_A",
                           "raft_stereo_tpu_torch/witfix_adopt.py::LOCK_B"]
        assert mod.LOCK_A is orig
        assert w.edges == {(("raft_stereo_tpu_torch/witfix_adopt.py", 3),
                            ("raft_stereo_tpu_torch/witfix_adopt.py", 4)),
                           (("raft_stereo_tpu_torch/witfix_adopt.py", 4),
                            ("raft_stereo_tpu_torch/witfix_adopt.py", 3))}
        assert len(unexplained_edges(w, model)) == 1
    finally:
        del sys.modules[spec.name]


# The least number of distinct observed edges the storm below maps to
# declarations (it read 7 when written: the program lock over _ENV_LOCK, the
# fault injector over the fake clock, ...; one below that), so an empty
# witness cannot pass.
MIN_MAPPED_EDGES = 6


def _mapped(witness, model):
    return {(a.key, b.key) for a, b in ((model.decl_at(*s), model.decl_at(*d))
                                        for s, d in witness.edges)
            if a is not None and b is not None and a.key != b.key}


def test_fault_storm_under_the_witness_stays_in_the_static_graph():
    """The port's fault storm (tests/test_torch_service.py::test_fault_storm)
    with the tiny model, built and served inside the witness with the
    module-level locks adopted: every nested acquisition it makes is an edge
    of the static graph, and it makes enough of them."""
    import torch

    from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo
    from raft_stereo_tpu_torch.faults import FakeClock, ServeFaultPlan, malformed_pairs
    from raft_stereo_tpu_torch.serve import (InferenceSession, ServiceConfig,
                                             SessionConfig, StereoService)
    tiny = dict(n_gru_layers=1, hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
    h, w = 40, 60
    model = package_model()
    params = init_raft_stereo(RAFTStereoConfig(**tiny), seed=0, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with LockWitness() as witness:
            adopted = witness.adopt_module_locks(model)
            cfg = RAFTStereoConfig(**{**tiny, "corr_implementation": "reg_cuda"})
            plan = ServeFaultPlan(compile_errors={i: ("mosaic" if i == 1 else "oom")
                                                  for i in range(8)},
                                  slow_forwards={2: 100.0})
            sess = InferenceSession(params, cfg,
                                    SessionConfig(valid_iters=4, segments=2, canary=False),
                                    device="cpu", fault_plan=plan, clock=FakeClock())
            svc = StereoService(sess, ServiceConfig(max_queue=8, workers=1))
            rng = np.random.default_rng(3)
            good = [(rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
                     rng.uniform(0, 255, (h, w, 3)).astype(np.float32)) for _ in range(4)]
            bad = malformed_pairs(h=h, w=w)
            stream = [
                {"id": "ok-1", "left": good[0][0], "right": good[0][1]},
                {"id": "nan", "left": bad["nan_pixels"][0], "right": bad["nan_pixels"][1]},
                {"id": "deadline", "left": good[1][0], "right": good[1][1],
                 "deadline_ms": 50_000.0},
                {"id": "channels", "left": bad["five_channel"][0],
                 "right": bad["five_channel"][1]},
                {"id": "ok-2", "left": good[2][0], "right": good[2][1]},
                {"id": "deadline-2", "left": good[3][0], "right": good[3][1],
                 "deadline_ms": 1e9},
            ]
            responses = {r["id"]: svc.handle(r) for r in stream}
            status = svc.status()
    finally:
        torch.set_num_threads(threads)
    assert all(r["status"] in ("ok", "rejected", "error") for r in responses.values())
    assert [responses[k]["status"] for k in ("ok-1", "deadline", "ok-2", "deadline-2")] == \
        ["ok"] * 4
    assert sess.breaker.exhausted and status["requests"]["ok"] == 4
    assert "raft_stereo_tpu_torch/serve/session.py::_ENV_LOCK" in adopted
    assert unexplained_edges(witness, model) == []
    mapped = _mapped(witness, model)
    assert len(mapped) >= MIN_MAPPED_EDGES, sorted(mapped)
    print("mapped edges:", len(mapped), *sorted(mapped), sep="\n")
    assert ("raft_stereo_tpu_torch/serve/session.py::_Program.lock",
            "raft_stereo_tpu_torch/serve/session.py::_ENV_LOCK") in mapped
