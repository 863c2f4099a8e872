"""The port's graftverify (``raft_stereo_tpu_torch.analysis.trace``): each
GV checker fires on its poisoned registry (``tests/torch_trace_fixtures/``,
tiny torch programs on the CPU) through the real CLI, the registry and
suppression contract, the recorder's text and launch stream, the real
registry at ``small`` geometry on the CPU, and the headline refusal
without a card.

The ladder and knob proofs need the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase 13 run them).
"""

import json
from pathlib import Path

import pytest
import torch

from raft_stereo_tpu_torch import kernels
from raft_stereo_tpu_torch.analysis.cli import main as cli_main
from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
from raft_stereo_tpu_torch.analysis.trace import (TraceContext, TraceEntry, TraceRegistry,
                                                  default_registry, run_trace_analysis)
from raft_stereo_tpu_torch.analysis.trace.checkers.gv102_ladder_vacuity import \
    LadderVacuityChecker
from raft_stereo_tpu_torch.analysis.trace.graphs import record, scrubbed_text

FIXTURES = Path(__file__).resolve().parent / "torch_trace_fixtures"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    # The recordings run full-width programs: keep them off the other test
    # workers' cores.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

POISONS = [
    ("gv101_upcast.py", "GV101"),
    ("gv102_noop_rung.py", "GV102"),
    ("gv103_host_sync.py", "GV103"),
    ("gv104_big_const.py", "GV104"),
    ("gv105_no_donation.py", "GV105"),
]


def _load_fixture(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"_gvfix_{name[:-3]}", str(FIXTURES / name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_registry()


def _dead_registry(message="the entry build raised"):
    def build():
        raise RuntimeError(message)
    return TraceRegistry(geometry="fixture",
                         entries=[TraceEntry(name="fixture/dead", build=build, env={})],
                         ladder_variants=[], knob_flips=[])


@pytest.mark.parametrize("fixture,code", POISONS)
def test_poisoned_fixture_exits_one(fixture, code, capsys):
    # The AST stage runs over the fixture file alone: the port's tree has
    # its own test.
    rc = cli_main([str(FIXTURES / fixture), "--trace", "--trace-registry",
                   str(FIXTURES / fixture), "--json", "--select",
                   "GV101,GV102,GV103,GV104,GV105"])
    payload = json.loads(capsys.readouterr().out)
    found = {f["code"] for f in payload["findings"]}
    assert rc == 1
    assert found == {code}, payload["findings"]  # its own code, never GV000


def test_gv102_fixture_fires_both_flavours():
    rep = run_trace_analysis(_load_fixture("gv102_noop_rung.py"),
                             checkers=[LadderVacuityChecker()])
    msgs = sorted(f.message for f in rep.findings)
    assert len(msgs) == 2
    assert any("IDENTICAL" in m for m in msgs)        # the vacuous rung
    assert any("stale-program" in m for m in msgs)    # the key gap


def test_gv105_fixture_names_the_leaves():
    rep = run_trace_analysis(_load_fixture("gv105_no_donation.py"))
    hits = [f for f in rep.findings if f.code == "GV105"]
    assert len(hits) == 1
    assert "2 of 2 state leaves" in hits[0].message and "bias, weight" in hits[0].message


def test_dead_entry_is_gv000_not_clean():
    rep = run_trace_analysis(_dead_registry())
    assert [f.code for f in rep.findings] == ["GV000"]
    assert "the entry build raised" in rep.findings[0].message


def test_registry_suppression_with_reason():
    reg = _load_fixture("gv104_big_const.py")
    reg.suppressions[("GV104", "fixture/big_const")] = "fixture: measured and accepted"
    rep = run_trace_analysis(reg)
    assert rep.ok and [f.code for f in rep.suppressed] == ["GV104"]
    assert rep.suppressed[0].suppress_reason == "fixture: measured and accepted"


@pytest.mark.parametrize("blank", ["", "   "])
def test_registry_reasonless_suppression_is_gv000(blank):
    reg = _load_fixture("gv104_big_const.py")
    reg.suppressions[("GV104", "fixture/big_const")] = blank
    rep = run_trace_analysis(reg)
    assert sorted(f.code for f in rep.findings) == ["GV000", "GV104"]  # can't hide itself


def test_select_keeps_gv000():
    rep = run_trace_analysis(_load_fixture("gv104_big_const.py"), select=("GV103",))
    assert rep.findings == []  # GV104 filtered away by --select
    rep = run_trace_analysis(_dead_registry("boom"), select=("GV103",))
    assert [f.code for f in rep.findings] == ["GV000"]  # never filterable


def test_recorded_text_is_deterministic_and_carries_launches():
    """Two recordings of one program give one text: operand labels, no
    addresses or data pointers; a kernel wrapper's launch (counted through
    ``kernels.count_launch``) sits in the op stream where it happened."""
    weight = torch.nn.Parameter(torch.ones(16, 16))

    def program(x):
        y = x @ weight
        kernels.count_launch("fixture_kernel", "v1")  # what a wrapper does on the card
        return y.relu().sum(dim=0)

    x = torch.ones(4, 16)
    before = (dict(kernels.launches), dict(kernels.variants))
    try:
        state = lambda: {"weight": weight}  # noqa: E731
        a, b = (record(program, (x,), state) for _ in range(2))
    finally:
        kernels.launches.clear()
        kernels.launches.update(before[0])
        kernels.variants.clear()
        kernels.variants.update(before[1])
    ta, tb = scrubbed_text(a), scrubbed_text(b)
    assert ta == tb
    assert "0x" not in ta and str(x.data_ptr()) not in ta
    lines = ta.splitlines()
    assert lines[0] == ("%1:float32[4, 16] = aten.mm.default(in:arg0:float32[4, 16], "
                        "p:weight:float32[16, 16])")
    assert lines[1] == "launch fixture_kernel:v1"
    assert a.launches() == {"fixture_kernel": 1}
    assert a.state_ptrs_before == a.state_ptrs_after


def test_small_geometry_records_every_entry_clean_on_the_cpu(capsys):
    rc = cli_main(["--trace", "--trace-geometry", "small", "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0, payload["findings"]
    assert payload["entries_traced"] == 8
    assert payload["findings"] == []
    # Nothing is suppressed: the refinement loop's resizes are gru16+32's
    # stages (their plain version here), so no bf16 entry's loop upcasts.
    assert payload["suppressed"] == []


def test_small_registry_names_the_eight_real_entries():
    reg = default_registry("small", device="cpu")
    assert [e.name for e in reg.entries] == [
        "serve/full", "serve/prepare", "serve/prepare_warm", "serve/segment",
        "serve/advance", "serve/epilogue", "eval/forward", "train/step"]
    assert reg.ladder_variants == [] and reg.knob_flips == []
    train = reg.entries[-1]
    assert train.in_place and train.fetches == ("engine/steps.py:TrainStep.__call__",)


def test_headline_registry_structure_without_recording():
    """The walk and the flips, built lazily (nothing runs): the untripped
    armed program and one per rung in ladder order, one probe per knob with
    a differing fingerprint and session cache key."""
    from raft_stereo_tpu_torch.serve.guard import DEFAULT_LADDER
    reg = default_registry("headline", device="cuda")
    assert [label for label, _ in reg.ladder_variants] == \
        ["untripped"] + [p.name for p in DEFAULT_LADDER]
    assert reg.ladder_variants[0][1].env["RAFT_CORR_PACK8"] == "1"
    assert reg.ladder_variants[0][1].env["RAFT_LANE_PACK8"] == "1"
    assert [kf.knob for kf in reg.knob_flips] == list(ENV_KNOBS)
    assert all(kf.flipped is not None for kf in reg.knob_flips)
    assert all(kf.base_key[0] != kf.flipped_key[0] and kf.base_key[1] != kf.flipped_key[1]
               for kf in reg.knob_flips)


def test_headline_without_cuda_exits_two(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_main(["--trace"]) == 2
    assert cli_main(["--trace", "--trace-geometry", "headline"]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError):
        default_registry("headline", device="cpu")


def test_cli_trace_registry_missing_is_internal_error(capsys):
    assert cli_main(["--trace", "--trace-registry", str(FIXTURES / "no_such.py")]) == 2
    capsys.readouterr()


def test_cli_list_checkers_includes_gv(capsys):
    assert cli_main(["--list-checkers"]) == 0
    out = capsys.readouterr().out
    for code in ("GL001", "GL006", "GV101", "GV102", "GV103", "GV104", "GV105"):
        assert code in out


def test_gv103_lets_the_declared_fetch_site_through():
    reg = _load_fixture("gv103_host_sync.py")
    entry = reg.entries[0]
    entry.fetches = ("gv103_host_sync.py:build_registry.<locals>.build.<locals>.fn",)
    assert run_trace_analysis(reg).findings == []


def test_gv101_exempts_plain_kernel_versions_and_the_accumulator():
    """An upcast inside a kernel's plain version (its code object in the
    recorder's kernel set) is exempt, and so is one that reaches the loop's
    accumulator line."""
    from raft_stereo_tpu_torch.analysis.trace.graphs import loop_region

    def kernel_plain(h):
        return (h.float() * 1.5).to(torch.bfloat16)

    def program(h):
        acc = torch.zeros((64, 16))
        for _ in range(2):
            h = kernel_plain(h)
            acc = acc + h.float()[0]
        return h, acc

    reg = TraceRegistry(
        geometry="fixture",
        entries=[TraceEntry(name="fixture/exempt", env={}, mixed_precision=True,
                            build=lambda: (program, (torch.ones((64, 64, 16),
                                                                dtype=torch.bfloat16),)))],
        ladder_variants=[], knob_flips=[], region=lambda: loop_region(program, "acc"))
    ctx = TraceContext(reg)
    ctx._codes = frozenset({kernel_plain.__code__})
    ctx._region = reg.region()
    assert run_trace_analysis(reg, context=ctx).findings == []
    ctx2 = TraceContext(reg)
    ctx2._codes = frozenset()
    ctx2._region = reg.region()
    assert [f.code for f in run_trace_analysis(reg, context=ctx2).findings] == ["GV101"]


def test_gv103_and_gv104_device_cases_on_a_synthetic_recording():
    """The card-only branches, on a recording made by hand: a copy of device
    data to the host, an .item() of device data, a data-dependent shape and
    a synchronize are host round trips (an .item() of a host counter the
    program does not own is not); a 3 MiB tensor held from outside and a
    4 MiB host tensor copied to the device are GV104's."""
    from raft_stereo_tpu_torch.analysis.trace.graphs import (EXTERNAL, PRODUCED, Op,
                                                             Operand, Recording, Sync)

    def t(label, origin, device="cuda:0", nbytes=4, shape=(1,)):
        return Operand(label, origin, "float32", shape, device, nbytes)

    mib = 2 ** 20
    events = [
        Op(0, "aten._to_copy.default", [t("%1", PRODUCED)], [t("%2", PRODUCED, "cpu")],
           "to host", site="serve/x.py:f"),
        Op(1, "aten._local_scalar_dense.default", [t("%1", PRODUCED)], [], "item",
           site="serve/x.py:f"),
        Op(2, "aten.nonzero.default", [t("%1", PRODUCED)], [t("%3", PRODUCED)], "nonzero",
           site="serve/x.py:g"),
        Sync(3, "serve/x.py:g"),
        Op(4, "aten._local_scalar_dense.default", [t("ext", EXTERNAL, "cpu")], [],
           "host counter", site="serve/x.py:g"),
        Op(5, "aten.mm.default", [t("%3", PRODUCED), t("ext", EXTERNAL, nbytes=3 * mib)],
           [t("%4", PRODUCED)], "held", site="serve/x.py:g"),
        Op(6, "aten._to_copy.default", [t("ext", EXTERNAL, "cpu", 4 * mib)],
           [t("%5", PRODUCED, nbytes=4 * mib)], "upload", site="serve/x.py:g"),
    ]
    rec = Recording(events, {}, {}, device="cuda:0")

    def findings(fetches=()):
        entry = TraceEntry(name="fixture/synthetic", build=lambda: None, env={},
                           fetches=fetches)
        reg = TraceRegistry(geometry="fixture", entries=[entry], ladder_variants=[],
                            knob_flips=[])
        ctx = TraceContext(reg)
        ctx._recordings[entry.name] = rec
        return sorted((f.code, f.message.split(" — ")[0])
                      for f in run_trace_analysis(reg, context=ctx).findings)

    got = findings()
    assert [c for c, _ in got] == ["GV103"] * 4 + ["GV104"] * 2, got
    assert any("a copy to the host" in m for _, m in got)
    assert any(".item() of the program's data" in m for _, m in got)
    assert any("data-dependent output shape" in m for _, m in got)
    assert any("torch.cuda.synchronize" in m for _, m in got)
    assert any("3.0 MiB" in m for _, m in got) and any("4.0 MiB" in m for _, m in got)
    # A declared fetch site lets its own round trips through, and no other.
    assert [c for c, _ in findings(fetches=("serve/x.py:f",))] == \
        ["GV103"] * 2 + ["GV104"] * 2
