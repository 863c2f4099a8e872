"""The port's host modules against the JAX package's: ``faults``, the
``obs/`` modules the serving session reads (``tracing``, ``flight``,
``deck``, ``capacity``, ``usage``), ``serve/validate``, ``serve/supervise``,
``serve/heal``, ``serve/degrade``'s host helpers and the knob registry.

The port keeps its own copy of each (it imports nothing of the JAX
package), so every test runs on both copies (``mods``, parametrized) and
pins the same behaviour; the knob registry and the failure-marker table,
which the port makes its own, are pinned against the port's code. No test
here needs a model.
"""

import ast
import json
import types
from pathlib import Path

import numpy as np
import pytest

import raft_stereo_tpu.faults as jx_faults
import raft_stereo_tpu.obs.capacity as jx_capacity
import raft_stereo_tpu.obs.deck as jx_deck
import raft_stereo_tpu.obs.flight as jx_flight
import raft_stereo_tpu.obs.metrics as jx_metrics
import raft_stereo_tpu.obs.tracing as jx_tracing
import raft_stereo_tpu.obs.usage as jx_usage
import raft_stereo_tpu.serve.degrade as jx_degrade
import raft_stereo_tpu.serve.heal as jx_heal
import raft_stereo_tpu.serve.supervise as jx_supervise
import raft_stereo_tpu.serve.validate as jx_validate
from raft_stereo_tpu.analysis import knobs as jx_knobs

import raft_stereo_tpu_torch.faults as pt_faults
import raft_stereo_tpu_torch.obs.capacity as pt_capacity
import raft_stereo_tpu_torch.obs.deck as pt_deck
import raft_stereo_tpu_torch.obs.flight as pt_flight
import raft_stereo_tpu_torch.obs.metrics as pt_metrics
import raft_stereo_tpu_torch.obs.tracing as pt_tracing
import raft_stereo_tpu_torch.obs.usage as pt_usage
import raft_stereo_tpu_torch.serve.degrade as pt_degrade
import raft_stereo_tpu_torch.serve.heal as pt_heal
import raft_stereo_tpu_torch.serve.supervise as pt_supervise
import raft_stereo_tpu_torch.serve.validate as pt_validate
from raft_stereo_tpu_torch.analysis import knobs as pt_knobs
from raft_stereo_tpu_torch.serve import guard as pt_guard

pytestmark = pytest.mark.obs

REPO = Path(__file__).resolve().parents[1]

JAX = types.SimpleNamespace(
    faults=jx_faults, capacity=jx_capacity, deck=jx_deck, flight=jx_flight,
    metrics=jx_metrics, tracing=jx_tracing, usage=jx_usage, degrade=jx_degrade,
    heal=jx_heal, supervise=jx_supervise, validate=jx_validate)
PORT = types.SimpleNamespace(
    faults=pt_faults, capacity=pt_capacity, deck=pt_deck, flight=pt_flight,
    metrics=pt_metrics, tracing=pt_tracing, usage=pt_usage, degrade=pt_degrade,
    heal=pt_heal, supervise=pt_supervise, validate=pt_validate)


@pytest.fixture(params=["jax", "port"])
def mods(request):
    return JAX if request.param == "jax" else PORT


# -- faults ---------------------------------------------------------------------


def test_serve_faults_ordinals_deterministic(mods):
    f = mods.faults
    faults = f.ServeFaults(f.ServeFaultPlan(compile_errors={1: "oom"}, poison_outputs=(2,)))
    assert faults.on_build() == 0
    with pytest.raises(f.InjectedKernelError, match="RESOURCE_EXHAUSTED"):
        faults.on_build()
    assert faults.on_build() == 2
    assert [faults.on_forward() for _ in range(3)] == [0, 1, 2]
    assert not faults.poisoned(1) and faults.poisoned(2)


def test_slow_forward_advances_the_fake_clock(mods):
    f = mods.faults
    clk = f.FakeClock()
    faults = f.ServeFaults(f.ServeFaultPlan(slow_forwards={1: 2.5}), clock=clk)
    faults.on_forward()
    assert clk.now() == 0.0
    faults.on_forward()
    assert clk.now() == 2.5


def test_fake_clock_sleep_advances(mods):
    clk = mods.faults.FakeClock(start=5.0)
    assert clk.now() == 5.0
    clk.sleep(2.5)
    assert clk.now() == 7.5


@pytest.mark.parametrize("kind,detail", [("oom", ""), ("mosaic", "gru1632"), ("other", "x")])
def test_injected_kernel_error_text(kind, detail):
    assert str(pt_faults.InjectedKernelError(kind, detail)) == \
        str(jx_faults.InjectedKernelError(kind, detail))


def test_poison_disparity_hits_the_center(mods):
    arr = np.zeros((1, 5, 7, 1), np.float32)
    out = mods.faults.poison_disparity(arr)
    assert np.isnan(out[0, 2, 3, 0]) and np.isnan(out).sum() == 1
    assert not np.isnan(arr).any()  # a copy


def test_malformed_pairs_are_the_same():
    a = jx_faults.malformed_pairs(h=8, w=12, oversize_pixels=100)
    b = pt_faults.malformed_pairs(h=8, w=12, oversize_pixels=100)
    assert a.keys() == b.keys()
    for name in a:
        for x, y in zip(a[name], b[name]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


def test_fault_plan_fields_are_the_same():
    for cls in ("FaultPlan", "ServeFaultPlan", "ChaosPlan", "WireChaosPlan"):
        jx = [f.name for f in jx_faults.dataclasses.fields(getattr(jx_faults, cls))]
        pt = [f.name for f in pt_faults.dataclasses.fields(getattr(pt_faults, cls))]
        assert jx == pt, cls


# -- admission, supervision, heal, degrade helpers ------------------------------


def test_validate_codes_are_the_same(mods):
    v = mods.validate
    cases = mods.faults.malformed_pairs(h=8, w=12, oversize_pixels=200)
    codes = {}
    for name, (left, right) in cases.items():
        with pytest.raises(v.InputRejected) as ei:
            v.validate_pair(left, right, v.AdmissionConfig(max_pixels=200))
        codes[name] = ei.value.code
    assert codes == {"nan_pixels": "nonfinite_input", "inf_pixels": "nonfinite_input",
                     "five_channel": "bad_channels", "zero_area": "zero_area",
                     "mismatched_shapes": "shape_mismatch", "wrong_rank": "wrong_rank",
                     "not_an_array": "wrong_rank", "oversized": "too_large"}
    good = np.ones((4, 6, 3), np.uint8)
    left, right = v.validate_pair(good, good, v.AdmissionConfig())
    assert left.shape == (1, 4, 6, 3) and left.dtype == np.float32


def test_invocation_watch_tracks_in_flight(mods):
    clk = mods.faults.FakeClock()
    watch = mods.supervise.InvocationWatch(clk)
    token = watch.begin("p1", "full", warming=False, est=0.5)
    clk.sleep(3.0)
    (inv,) = watch.active()
    assert (inv.program, inv.kind, watch.count, watch.total) == ("p1", "full", 1, 1)
    (row,) = watch.overdue(clk.now(), floor_s=1.0)
    assert row[1] == 3.0 and row[2] == max(0.5 * mods.supervise.WATCHDOG_FACTOR, 1.0)
    watch.end(token)
    assert watch.active() == [] and watch.total == 1


def test_parse_number_names_the_knob(mods):
    with pytest.raises(ValueError, match="RAFT_X"):
        mods.supervise._parse_number("RAFT_X", "soon", int)
    assert mods.supervise._parse_number("RAFT_X", "12", int) == 12


def test_heal_resolvers(mods, monkeypatch):
    h = mods.heal
    for knob in ("RAFT_HEAL", "RAFT_HEAL_BACKOFF_MS", "RAFT_HEAL_FLAP_CAP"):
        monkeypatch.delenv(knob, raising=False)
    assert h.resolve_heal_enabled() is True and h.resolve_heal_enabled(False) is False
    monkeypatch.setenv("RAFT_HEAL", "0")
    assert h.resolve_heal_enabled() is False
    assert h.resolve_heal_backoff_ms() == 30_000.0
    monkeypatch.setenv("RAFT_HEAL_BACKOFF_MS", "-1")
    with pytest.raises(ValueError, match="RAFT_HEAL_BACKOFF_MS"):
        h.resolve_heal_backoff_ms()
    monkeypatch.setenv("RAFT_HEAL_FLAP_CAP", "3")
    assert h.resolve_heal_flap_cap() == 3


def test_half_resolution_helpers_are_the_same():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (1, 9, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(pt_degrade._downscale_half(img),
                                  jx_degrade._downscale_half(img))
    flow = rng.normal(size=(1, 5, 7, 1)).astype(np.float32)
    np.testing.assert_array_equal(pt_degrade._restore_half(flow, 9, 13),
                                  jx_degrade._restore_half(flow, 9, 13))
    assert pt_degrade.SAFETY == jx_degrade.SAFETY


# -- tracing, flight, deck, usage, capacity --------------------------------------


def _trace_doc(mods):
    clk = mods.faults.FakeClock()
    tr = mods.tracing.Tracer(clock=clk, sink="")
    t = tr.start_request("r")
    t.mark("admission")
    clk.sleep(0.5)
    t.mark("queue_wait")
    with t.span("prepare"):
        clk.sleep(0.25)
    t.add_span("upload", 0.0, 0.4, concurrent=True)
    t.event("breaker_trip", rung="corr_kernel")
    t.finish(status="ok", quality="full")
    t.finish(status="error")  # idempotent
    return tr, tr.last()


def test_tracer_span_tree(mods):
    tr, doc = _trace_doc(mods)
    s = doc["summary"]
    assert s["total_ms"] == pytest.approx(750.0)
    assert s["tiled_ms"] == pytest.approx(750.0)  # the concurrent span is excluded
    assert s["kinds"]["upload"]["ms"] == pytest.approx(400.0)
    assert doc["meta"] == {"status": "ok", "quality": "full"}
    assert len(tr.timelines()) == 1


def test_tracer_timelines_are_the_same():
    _, a = _trace_doc(JAX)
    _, b = _trace_doc(PORT)
    a.pop("trace_id", None), b.pop("trace_id", None)
    # The port's timelines end with the clock pair that maps their spans
    # onto the profiler's clock; the rest is the JAX package's.
    assert set(b.pop("clock")) == {"monotonic", "epoch_ns"}
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_tracer_sink_failure_never_raises(mods, tmp_path):
    tr = mods.tracing.Tracer(clock=mods.faults.FakeClock(),
                             sink=str(tmp_path / "no_such_dir" / "t.jsonl"))
    tr.start_request("r0").finish(status="ok")
    assert tr.status()["sink"] is None
    tr.start_request("r1").finish(status="ok")
    assert len(tr.timelines()) == 2


def test_disabled_tracer_is_noop(mods):
    tr = mods.tracing.Tracer(clock=mods.faults.FakeClock(), enabled=False, sink="")
    assert tr.start_request("x") is mods.tracing.NULL_TRACE


def test_flight_bounded_oldest_first(mods, tmp_path):
    rec = mods.flight.FlightRecorder(out_dir=str(tmp_path), limit=2)
    for i in range(4):
        assert rec.record({"i": i}, trace_id=f"req-{i}") is not None
    docs = [json.loads(open(p).read()) for p in rec.records()]
    assert [d["i"] for d in docs] == [2, 3]
    st = rec.status()
    assert st["recorded"] == 4 and st["evicted"] == 2


def test_flight_disabled_without_dir(mods, monkeypatch):
    monkeypatch.delenv("RAFT_FLIGHT_DIR", raising=False)
    rec = mods.flight.FlightRecorder()
    assert not rec.enabled and rec.record({"x": 1}) is None
    assert rec.status()["skipped"] == 1


def test_deck_ring_bounded_and_dropped_counted(mods):
    clk = mods.faults.FakeClock()
    deck = mods.deck.TickDeck(clock=clk, ticks=4)
    for _ in range(10):
        t = deck.begin_tick(bucket="64x64", generation=1, queue_depth=0)
        clk.sleep(0.1)
        deck.end_tick(t)
    assert deck.status() == {"ring": 4, "recorded": 10, "dropped": 6, "warm_records": 0}
    assert [t["seq"] for t in deck.doc()["ticks"]] == [6, 7, 8, 9]


def test_deck_standalone_invocation_rows(mods):
    clk = mods.faults.FakeClock()
    deck = mods.deck.TickDeck(clock=clk, ticks=8)
    seqs = [deck.note_invocation(kind="full", program="p", b=1, h=64, w=64, t0=float(i),
                                 t1=i + 0.5, host_s=0.1, device_s=0.4, warming=w)
            for i, w in enumerate((True, False, False))]
    assert all(s is not None for s in seqs)
    assert deck.status()["recorded"] == 3


def test_deck_ticks_are_the_same():
    docs = []
    for m in (JAX, PORT):
        clk = m.faults.FakeClock()
        deck = m.deck.TickDeck(clock=clk, ticks=8)
        for i in range(3):
            t = deck.begin_tick(bucket="64x64", generation=1, queue_depth=i)
            clk.sleep(0.25)
            deck.end_tick(t)
        docs.append(deck.doc())
    assert json.dumps(docs[0], sort_keys=True) == json.dumps(docs[1], sort_keys=True)


def test_usage_add_device_exact_across_riders(mods):
    u = mods.usage.UsageAccountant(mods.metrics.MetricsRegistry(), max_tenants=8)
    rng = np.random.default_rng(1)
    for _ in range(50):
        riders = [u.label(f"t{int(rng.integers(0, 5))}") for _ in range(int(rng.integers(1, 9)))]
        u.add_device(riders, float(rng.uniform(0, 2.0)), flops=float(rng.integers(0, 10**9)))
    doc = u.doc()
    assert sum(t["device_ns"] for t in doc["by_tenant"].values()) == doc["device_ns_total"]
    assert sum(t["flops"] for t in doc["by_tenant"].values()) == doc["flops_total"]


def test_usage_label_first_come_bounded(mods):
    u = mods.usage.UsageAccountant(mods.metrics.MetricsRegistry(), max_tenants=2)
    assert u.label("a") == "a" and u.label("b") == "b"
    assert u.label("c") == mods.usage.OVERFLOW_LABEL
    assert mods.usage.sanitize_tenant("Bad Tenant!\n") == "Bad_Tenant__"


def test_capacity_models_are_the_same():
    rows = [{"kind": "prepare", "b": 1, "h": 64, "w": 64, "iters": 0, "est": 0.1},
            {"kind": "segment", "b": 1, "h": 64, "w": 64, "iters": 2, "est": 0.2},
            {"kind": "full", "b": 1, "h": 96, "w": 128, "iters": 32, "est": 2.0}]
    a = jx_capacity.model(rows, segments=2, valid_iters=4)
    b = pt_capacity.model(rows, segments=2, valid_iters=4)
    assert a == b
    assert b["by_bucket"]["96x128"]["rps"] == pytest.approx(0.5)


def test_resolve_capacity_window_env(mods, monkeypatch):
    monkeypatch.setenv("RAFT_CAPACITY_WINDOW_MS", "5000")
    assert mods.capacity.resolve_capacity_window_s() == 5.0
    monkeypatch.setenv("RAFT_CAPACITY_WINDOW_MS", "never")
    with pytest.raises(ValueError, match="RAFT_CAPACITY_WINDOW_MS"):
        mods.capacity.resolve_capacity_window_s()


# -- the port's own: knobs and the failure-marker table --------------------------


def test_port_knobs_are_the_switches_it_reads():
    assert set(pt_knobs.ENV_KNOBS) == {
        "RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER", "RAFT_CORR_PACK8", "RAFT_LANE_PACK8",
        "RAFT_FUSED_ENCODERS", "RAFT_STREAM_TAIL"}
    assert set(pt_knobs.ENV_KNOBS) <= set(jx_knobs.ENV_KNOBS)
    assert set(pt_knobs.SERVE_ENV_KNOBS) <= set(jx_knobs.SERVE_ENV_KNOBS)
    assert set(pt_knobs.HOST_ENV_KNOBS) <= set(jx_knobs.HOST_ENV_KNOBS) | {"RAFT_LEDGER"}


def _port_env_reads() -> set:
    """Every literal ``RAFT_*`` name the port reads from the environment
    (``os.environ.get`` / ``os.environ[...]``), the bench's own knobs
    aside (the bare prefix, which the linter matches reads against, is no
    name)."""
    names = set()
    for path in (REPO / "raft_stereo_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and node.value.startswith("RAFT_") and node.value.isupper() \
                    and node.value != "RAFT_":
                names.add(node.value)
    return {n for n in names if not n.startswith("RAFT_BENCH_")}


def test_every_port_knob_is_registered_once():
    """Each RAFT_* name in the port is in exactly one registry: a switch
    that shapes a program and is missing from ENV_KNOBS would not key the
    session's programs."""
    registries = (pt_knobs.ENV_KNOBS, pt_knobs.SERVE_ENV_KNOBS, pt_knobs.HOST_ENV_KNOBS)
    for name in _port_env_reads():
        assert sum(name in r for r in registries) == 1, name


def test_kernel_failure_marker_table():
    for marker in pt_guard.KERNEL_FAILURE_MARKERS:
        assert marker.substring == marker.substring.lower()
        assert marker.category in ("oom", "kernel_build", "kernel_launch", "cuda_library")
        assert marker.note
        exc = RuntimeError(f"prefix {marker.substring.upper()} suffix")
        assert pt_guard.match_failure_marker(exc) is marker
        assert pt_guard.is_kernel_failure(exc)
    for benign in (ValueError("bad argument"), KeyError("missing"),
                   RuntimeError("deadline blown")):
        assert pt_guard.match_failure_marker(benign) is None
        assert not pt_guard.is_kernel_failure(benign)


@pytest.mark.parametrize("kind", ["oom", "mosaic"])
def test_injected_errors_are_kernel_failures(kind):
    assert pt_guard.is_kernel_failure(pt_faults.InjectedKernelError(kind))


def test_kernel_failure_by_type_name():
    class OutOfMemoryError(RuntimeError):
        pass
    assert pt_guard.is_kernel_failure(OutOfMemoryError("whatever"))


_TORCH_CUDA_HINT = ("\nCUDA kernel errors might be asynchronously reported at some other "
                    "API call, so the stacktrace below might be incorrect.\nFor debugging "
                    "consider passing CUDA_LAUNCH_BLOCKING=1\nCompile with "
                    "`TORCH_USE_CUDA_DSA` to enable device-side assertions.\n")


@pytest.mark.parametrize("msg,code", [
    ("CUDA error: an illegal memory access was encountered", "cuda_sticky_error"),
    ("CUDA error: unspecified launch failure", "cuda_sticky_error"),
    ("CUDA kernel resident failed to launch: cudaError_t 700", "cuda_sticky_error"),
    ("CUDA kernel gru1632 failed to launch: cudaError_t 719", "cuda_sticky_error"),
    ("CUDA kernel gru1632 failed to launch: cudaError_t 1", None),
    ("CUDA out of memory", None),
    ("CUDA error: device-side assert triggered" + _TORCH_CUDA_HINT, "cuda_sticky_error"),
    # torch appends the same hint to every CUDA error, sticky or not
    ("CUDA error: operation not permitted when stream is capturing" + _TORCH_CUDA_HINT,
     None),
])
def test_fatal_codes(msg, code):
    assert pt_guard.fatal_code(RuntimeError(msg)) == code


def test_capture_failure_is_fatal():
    exc = RuntimeError("operation not permitted when stream is capturing")
    assert pt_guard.fatal_code(exc) is None
    exc._raft_phase = pt_guard.CAPTURE_PHASE
    assert pt_guard.fatal_code(exc) == "capture_failed"
