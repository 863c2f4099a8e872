"""The port's ``raft.*`` profiler ranges and the clock pair of its request
timelines (``obs/tracing.py``), on the CPU with the tiny model.

- ``stage()`` opens nothing without a profiler (its enter op patched to
  raise, through every path that opens one), nothing while a CUDA graph is
  captured, and a range carrying the request's trace number or the tick's
  seq when a profiler records shapes.
- The serving path's ranges in order (``raft.validate``, ``raft.pad``,
  ``raft.copy_in``, ``raft.replay``, ``raft.copy_out``, ``raft.unpad``),
  the scheduler's (``raft.pad``, ``raft.upload`` on the uploader thread,
  one ``raft.tick`` a tick), the model's (``raft.encode`` <
  ``raft.loop`` < ``raft.epilogue``) and ``demo.infer_pair``'s.
- The timelines: the ``validate`` and ``pad`` tiling spans keep the
  FakeClock reconciliation exact; a program span's copy-in, replay and
  copy-out split lies within it; the ``clock`` pair maps a sink span onto
  its range's profiler start within 1 ms.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo, raft_stereo_forward
from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
from raft_stereo_tpu_torch.demo import infer_pair
from raft_stereo_tpu_torch.faults import FakeClock, RealClock, ServeFaultPlan
from raft_stereo_tpu_torch.obs import profiler as pf
from raft_stereo_tpu_torch.obs import tracing
from raft_stereo_tpu_torch.serve import (InferenceSession, ServiceConfig, SessionConfig,
                                         StereoService)

pytestmark = pytest.mark.obs

TINY = dict(n_gru_layers=1, hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
H, W = 40, 60
SERVE_ORDER = ["raft.validate", "raft.pad", "raft.copy_in", "raft.replay", "raft.copy_out",
               "raft.unpad"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    for knob in ENV_KNOBS + ("RAFT_TRACE", "RAFT_BATCH_BUCKETS"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def tiny_cfg():
    return RAFTStereoConfig(**TINY)


@pytest.fixture(scope="module")
def tiny_model(tiny_cfg):
    return init_raft_stereo(tiny_cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 255, (H, W, 3)).astype(np.float32),
            rng.uniform(0, 255, (H, W, 3)).astype(np.float32))


def make_service(model, cfg, *, max_batch=1, clock=None, plan=None, warm=True):
    session = InferenceSession(model, cfg, SessionConfig(
        valid_iters=4, segments=2, max_batch=max_batch, canary=False,
        warmup_shapes=((H, W),) if warm else ()), device="cpu", clock=clock or FakeClock(),
        fault_plan=plan)
    return session, StereoService(session, ServiceConfig(max_queue=8, workers=1)).start()


def traced(fn, shapes=True):
    """Run ``fn`` under a CPU profiler over every thread; its ``raft.*``
    ranges in start order as (start_ns, end_ns, name, inputs, thread)."""
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=shapes,
                 experimental_config=config) as prof:
        out = fn()
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                     list(e.concrete_inputs()), e.start_thread_id())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("raft."))
    return out, ranges


def trace_number(trace_id):
    return int(trace_id.split("-")[1])


# -- stage() ------------------------------------------------------------------------


@pytest.fixture
def no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened with no profiler collecting")
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", refuse)


@pytest.mark.parametrize("path", ["stage", "worker", "scheduler", "forward", "infer_pair"])
def test_no_profiler_no_range(no_range, tiny_model, tiny_cfg, pair, path):
    if path == "stage":
        trace = tracing.Tracer(clock=FakeClock(), sink="").start_request("r")
        with tracing.stage("pad", trace), tracing.stage("tick", tick=3), trace.span("unpad"):
            pass
        assert [s.kind for s in trace.spans] == ["unpad"]
    elif path in ("worker", "scheduler"):
        session, svc = make_service(tiny_model, tiny_cfg,
                                    max_batch=4 if path == "scheduler" else 1)
        with svc:
            resp = svc.submit({"id": "a", "left": pair[0], "right": pair[1]}).result()
        assert resp["status"] == "ok"
    elif path == "forward":
        img = torch.from_numpy(np.stack([pair[0][:32, :32]]))
        raft_stereo_forward(tiny_model, img, img, iters=2)
    else:
        infer_pair(tiny_model, pair[0][None], pair[1][None], iters=2)


def test_stage_carries_the_trace_number_or_the_tick_seq():
    trace = tracing.Tracer(clock=FakeClock(), sink="").start_request("r")

    def run():
        with tracing.stage("pad", trace):
            pass
        with tracing.stage("copy_in", trace, tick=12):
            pass
        with tracing.stage("encode"):
            pass
    _, ranges = traced(run)
    assert [(r[2], r[3][:1]) for r in ranges] == [
        ("raft.pad", [trace_number(trace.trace_id)]), ("raft.copy_in", [12]),
        ("raft.encode", [])]


def test_stage_opens_nothing_while_a_graph_is_captured(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)

    def run():
        with tracing.stage("replay"):
            torch.ones(4) * 2
    _, ranges = traced(run)
    assert ranges == []


# -- the serving path ----------------------------------------------------------------


def test_worker_path_ranges_in_order_with_the_trace_number(tiny_model, tiny_cfg, pair):
    session, svc = make_service(tiny_model, tiny_cfg)
    with svc:
        resp, ranges = traced(lambda: svc.submit(
            {"id": "a", "left": pair[0], "right": pair[1]}).result())
    assert resp["status"] == "ok"
    doc = session.tracer.last()
    serve = [r for r in ranges if r[2] in SERVE_ORDER]
    assert [r[2] for r in serve] == SERVE_ORDER
    assert all(r[3][:1] == [trace_number(doc["trace_id"])] for r in serve)
    starts = [r[0] for r in serve]
    assert starts == sorted(starts)
    # The model's ranges open inside the replay (an eager program's call).
    replay = next(r for r in serve if r[2] == "raft.replay")
    model = [r for r in ranges if r[2] in ("raft.encode", "raft.loop", "raft.epilogue")]
    assert len(model) == 3 and all(replay[0] <= r[0] and r[1] <= replay[1] for r in model)


def test_rejected_input_is_validated_then_refused(tiny_model, tiny_cfg, pair):
    session, svc = make_service(tiny_model, tiny_cfg, warm=False)
    with svc:
        resp, ranges = traced(lambda: svc.submit(
            {"id": "bad", "left": pair[0][:10], "right": pair[1]}).result())
    assert resp["status"] != "ok"
    assert [r[2] for r in ranges] == ["raft.validate"]
    kinds = [s["kind"] for s in session.tracer.last()["spans"]]
    assert kinds[:2] == ["validate", "admission"]


def test_forward_ranges_encode_loop_epilogue(tiny_model, pair):
    img1 = torch.from_numpy(pair[0][None, :32, :64].copy())
    img2 = torch.from_numpy(pair[1][None, :32, :64].copy())
    _, ranges = traced(lambda: raft_stereo_forward(tiny_model, img1, img2, iters=2))
    assert [r[2] for r in ranges] == ["raft.encode", "raft.loop", "raft.epilogue"]
    assert ranges[0][1] <= ranges[1][0] and ranges[1][1] <= ranges[2][0]


def test_infer_pair_pads_and_unpads_around_the_forward(tiny_model, pair):
    _, ranges = traced(lambda: infer_pair(tiny_model, pair[0][None], pair[1][None], iters=2))
    assert [r[2] for r in ranges] == ["raft.pad", "raft.encode", "raft.loop", "raft.epilogue",
                                      "raft.unpad"]


def test_scheduler_ranges_and_spans(tiny_model, tiny_cfg, pair):
    session, svc = make_service(tiny_model, tiny_cfg, max_batch=4)
    before = max((t["seq"] for t in session.deck.snapshot()), default=-1)

    def serve():
        with svc:  # stopped inside the window: every tick has closed
            return [f.result() for f in [
                svc.submit({"id": i, "left": pair[0], "right": pair[1]}) for i in range(3)]]
    resps, ranges = traced(serve)
    ticks = [t for t in session.deck.snapshot() if t["seq"] > before and t["kind"] == "tick"]
    assert all(r["status"] == "ok" for r in resps)
    tick_ranges = [r for r in ranges if r[2] == "raft.tick"]
    assert sorted(r[3][0] for r in tick_ranges) == sorted(t["seq"] for t in ticks)
    # The uploader pads and uploads on its own thread, a pair each.
    upload = [r for r in ranges if r[2] == "raft.upload"]
    pads = [r for r in ranges if r[2] == "raft.pad"]
    assert len(upload) == len(pads) == 3
    assert {r[4] for r in upload} == {r[4] for r in pads}
    assert not {r[4] for r in upload} & {r[4] for r in tick_ranges}
    # A batched call's stages carry the tick's seq and lie inside its range.
    seqs = {r[3][0] for r in tick_ranges}
    calls = [r for r in ranges if r[2] in ("raft.copy_in", "raft.replay", "raft.copy_out")]
    assert calls and all(r[3][0] in seqs for r in calls)
    for doc in session.tracer.timelines()[-3:]:
        spans = doc["spans"]
        kinds = [s["kind"] for s in spans]
        assert kinds.index("pad") < kinds.index("upload")
        assert all(s.get("concurrent") for s in spans if s["kind"] in ("pad", "upload"))
        for s in spans:
            if s["kind"] in ("prepare", "advance", "epilogue"):
                assert {"copy_in_ms", "replay_ms", "copy_out_ms",
                        "copy_in_bytes"} <= set(s["attrs"])


# -- the timelines -------------------------------------------------------------------


@pytest.mark.parametrize("deadline_ms", [None, 60_000.0], ids=["full", "segmented"])
def test_fake_clock_reconciles_with_validate_and_pad(tiny_model, tiny_cfg, pair, deadline_ms):
    clk = FakeClock()
    session, svc = make_service(tiny_model, tiny_cfg, clock=clk, warm=False,
                                plan=ServeFaultPlan(slow_forwards={0: 0.25, 1: 0.125, 2: 0.0625}))
    request = {"id": "a", "left": pair[0], "right": pair[1]}
    if deadline_ms is not None:
        request["deadline_ms"] = deadline_ms
    with svc:
        assert svc.submit(request).result()["status"] == "ok"
    doc = session.tracer.last()
    s = doc["summary"]
    assert s["total_ms"] == pytest.approx(437.5 if deadline_ms else 250.0)
    assert s["tiled_ms"] == pytest.approx(s["total_ms"])
    kinds = [sp["kind"] for sp in doc["spans"] if not sp.get("concurrent")]
    programs = ["full"] if deadline_ms is None else ["prepare", "segment", "segment"]
    assert kinds == ["validate", "admission", "queue_wait", "pad", *programs, "unpad"]


def test_program_span_split_lies_within_the_span(tiny_model, tiny_cfg, pair):
    session, svc = make_service(tiny_model, tiny_cfg, clock=RealClock())
    with svc:
        for i in range(2):
            svc.submit({"id": i, "left": pair[0], "right": pair[1]}).result()
    full = [s for s in session.tracer.last()["spans"] if s["kind"] == "full"]
    assert len(full) == 1
    a = full[0]["attrs"]
    assert 0 < a["copy_in_ms"] + a["replay_ms"] + a["copy_out_ms"] <= full[0]["ms"]
    assert a["copy_in_bytes"] == 2 * 64 * 64 * 3 * 4  # the pair at its 64x64 bucket


def test_timelines_end_with_the_clock_pair(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TRACE", str(tmp_path / "t.jsonl"))
    clk = FakeClock()
    tr = tracing.Tracer(clock=clk)
    t = tr.start_request("r")
    clk.sleep(2.0)
    t.finish()
    tr.close()
    sink = json.loads((tmp_path / "t.jsonl").read_text())
    ring = tr.last()
    assert ring["clock"] == sink["clock"]
    assert sink["clock"]["monotonic"] == pytest.approx(2.0)
    assert abs(sink["clock"]["epoch_ns"] / 1e9 - __import__("time").time()) < 60


def test_sink_span_maps_onto_its_range_within_1ms(tiny_model, tiny_cfg, pair, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("RAFT_TRACE", str(tmp_path / "spans.jsonl"))
    session, svc = make_service(tiny_model, tiny_cfg, clock=RealClock())
    with svc:
        _, ranges = traced(lambda: svc.submit(
            {"id": "a", "left": pair[0], "right": pair[1]}).result(), shapes=False)
    session.tracer.close()
    doc = json.loads((tmp_path / "spans.jsonl").read_text().splitlines()[-1])
    clock = doc["clock"]
    for kind in ("validate", "pad", "unpad"):
        span = next(s for s in doc["spans"] if s["kind"] == kind)
        mapped = clock["epoch_ns"] + (span["t0"] - clock["monotonic"]) * 1e9
        start = next(r[0] for r in ranges if r[2] == f"raft.{kind}")
        assert abs(mapped - start) < 1e6, kind


def test_profiler_window_records_the_serving_threads(tiny_model, tiny_cfg, pair, tmp_path):
    session, svc = make_service(tiny_model, tiny_cfg)
    window = pf.ProfilerWindow(str(tmp_path))
    with svc:
        with window.window():
            svc.submit({"id": "a", "left": pair[0], "right": pair[1]}).result()
    path, = tmp_path.glob("trace-*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert set(SERVE_ORDER) <= names
