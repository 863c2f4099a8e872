"""The port's video streams (serve/stream.py and the scheduler's warm rows)
on the CPU.

Mirrors every case of the JAX package's stream battery
(tests/test_stream.py) with its tiny model (TINY, pairs of 40x60 bucketed
to 64x64), ``device="cpu"`` and a ``FakeClock``:

- the prepare_warm seam: a zero seed is bit for bit the cold prepare; the
  warm chain (prepare_warm + advance + epilogue) is bit for bit the port's
  forward with ``flow_init`` here (both plain on the CPU; on the card the
  warm chain keeps the resident kernel and matches that forward within the
  canary band, ``chip_smoke.py`` phase 9) and within 1e-4 px of the JAX
  package's warm chain on transplanted weights; ``dnorm`` is the segment
  mean of |delta x| and equals JAX's;
- serving: a stream's first frame is bit for bit its stateless response,
  warm frames exit ``converged:k``, the deck, program counters, usage and
  trace spans see the warm joins; the sequential path and the StreamRunner;
- the session table, driven identically on the port's and the JAX
  package's ``StreamManager`` (the JAX one over a host-only stand-in of its
  session): a session storm, the per-tenant cap, TTL expiry with a deposit
  after it, and a bounce harvest that keeps the seed;
- mixed cold and warm joiners in one batch bucket; the knob errors.
"""

import time
import types

import numpy as np
import pytest
import torch

import jax

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.faults import FakeClock as JaxFakeClock
from raft_stereo_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from raft_stereo_tpu.obs.usage import UsageAccountant as JaxUsage
from raft_stereo_tpu.ops.padder import InputPadder as JaxPadder
from raft_stereo_tpu.serve import stream as jax_stream
from raft_stereo_tpu.serve.session import build_program as jax_build_program
from raft_stereo_tpu.transplant.torch_loader import transplant_state_dict

import raft_stereo_tpu_torch.serve.stream as pt_stream
from raft_stereo_tpu_torch import RAFTStereo, RAFTStereoConfig, init_raft_stereo
from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
from raft_stereo_tpu_torch.faults import FakeClock
from raft_stereo_tpu_torch.models import (raft_stereo_forward, raft_stereo_prepare,
                                          raft_stereo_segment_carry)
from raft_stereo_tpu_torch.ops.padder import InputPadder
from raft_stereo_tpu_torch.serve import (BatchScheduler, InferenceSession, ServiceConfig,
                                         SessionConfig, StereoService, StreamRunner)
from raft_stereo_tpu_torch.serve.session import build_program
from raft_stereo_tpu_torch.serve.stream import StreamManager
from raft_stereo_tpu_torch.serve.validate import AdmissionConfig, validate_pair
from raft_stereo_tpu_torch.transplant import load_state_dict, params_from_jax

pytestmark = pytest.mark.serve

TINY = dict(n_gru_layers=1, hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
H, W = 40, 60  # not multiples of 32: padding really engages


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    for knob in ENV_KNOBS + ("RAFT_BATCH_BUCKETS", "RAFT_STREAM_SESSIONS",
                             "RAFT_STREAM_TTL_MS", "RAFT_CONVERGE_TOL"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def tiny_cfg():
    return RAFTStereoConfig(**TINY)


@pytest.fixture(scope="module")
def tiny_params(tiny_cfg):
    """The port's model, seeded, its flow head tempered (random weights
    move coords by tens of px an iteration, which no tolerance survives)."""
    model = init_raft_stereo(tiny_cfg, seed=3, device="cpu")
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.02)
        model.update_block.flow_head.conv2.bias.mul_(0.02)
    return model.eval()


@pytest.fixture(scope="module")
def jax_twin(tiny_params, tiny_cfg):
    """(jax params, jax cfg, the port model loaded back from them): the
    same fp32 weights on both sides."""
    jcfg = JaxConfig(**TINY)
    params = transplant_state_dict(tiny_params.state_dict(), jcfg)
    model = RAFTStereo(tiny_cfg)
    load_state_dict(model, params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), tiny_cfg))
    return params, jcfg, model.eval()


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    return (rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32),
            rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32))


def canonical(pair):
    return validate_pair(pair[0], pair[1], AdmissionConfig())


def padded(pair):
    """Bucket-padded numpy arrays (the raw 40x60 is not divisible by the
    downsampling), the padding serving applies."""
    i1, i2 = canonical(pair)
    return InputPadder(i1.shape, divis_by=32, bucket=32).pad_np(i1, i2)


def make_session(model, cfg, clock=None, **kw):
    return InferenceSession(model, cfg, SessionConfig(valid_iters=4, segments=2, canary=False,
                                                      **kw),
                            device="cpu", clock=clock or FakeClock())


@pytest.fixture(scope="module")
def bsvc(tiny_params, tiny_cfg):
    """Shared batched service (programs accumulate across tests)."""
    svc = StereoService(make_session(tiny_params, tiny_cfg, max_batch=4),
                        ServiceConfig(max_queue=16)).start()
    yield svc
    svc.stop()


def _bits(x) -> bytes:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x).tobytes()


# ---------------------------------------------------------------------------
# The prepare_warm seam.
# ---------------------------------------------------------------------------


def test_prepare_warm_zero_flow_is_bitwise_cold_prepare(tiny_params, tiny_cfg, pair):
    """prepare_warm with an all-zero seed computes coords0 + 0.0: bit for
    bit the cold prepare (no other carry leaf sees the seed)."""
    i1, i2 = (torch.from_numpy(a) for a in padded(pair))
    (cold,) = build_program("prepare", tiny_params, 0)(i1, i2)
    f = tiny_cfg.downsample_factor
    zeros = torch.zeros((1, i1.shape[1] // f, i1.shape[2] // f, 1))
    (warm,) = build_program("prepare_warm", tiny_params, 0)(i1, i2, zeros)
    flat_c, flat_w = [], []
    from raft_stereo_tpu_torch.models.raft_stereo import _map_carry
    _map_carry(lambda x: flat_c.append(_bits(x)), cold)
    _map_carry(lambda x: flat_w.append(_bits(x)), warm)
    assert cold.keys() == warm.keys() and len(flat_c) == len(flat_w)
    assert flat_c == flat_w


def test_warm_chain_matches_forward_with_flow_init(jax_twin, tiny_cfg, pair):
    """prepare_warm(seed) + two advance segments + epilogue: bit for bit
    the port's forward with the same flow_init (both plain here), and
    within 1e-4 px of the JAX package's same chain on the same weights."""
    params, jcfg, model = jax_twin
    i1, i2 = padded(pair)
    f = tiny_cfg.downsample_factor
    h8, w8 = i1.shape[1] // f, i1.shape[2] // f
    flow_x = np.random.default_rng(5).uniform(-1.5, 1.5, (1, h8, w8, 1)).astype(np.float32)
    t1, t2, tx = (torch.from_numpy(a) for a in (i1, i2, flow_x))
    flow_full = torch.cat([tx, torch.zeros_like(tx)], dim=-1)
    _, up_ref = raft_stereo_forward(model, t1, t2, iters=4, flow_init=flow_full)

    (state,) = build_program("prepare_warm", model, 0)(t1, t2, tx)
    for _ in range(2):
        state, _, _ = build_program("advance", model, 2)(state)
    up, low = build_program("epilogue", model, 0)(state)
    assert _bits(up) == _bits(up_ref)
    assert low.shape == (1, h8, w8, 1)

    (jstate,) = jax.jit(jax_build_program("prepare_warm", jcfg, 0))(params, i1, i2, flow_x)
    adv = jax.jit(jax_build_program("advance", jcfg, 2))
    for _ in range(2):
        jstate, _, _ = adv(params, jstate)
    jup, jlow = jax.jit(jax_build_program("epilogue", jcfg, 0))(params, jstate)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), rtol=0, atol=1e-4)
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow), rtol=0, atol=1e-4)


def test_advance_dnorm_is_segment_mean_delta(jax_twin, tiny_cfg, pair):
    """The convergence monitor's definition: dnorm == mean |coords1_out -
    coords1_in|_x / iters, per row; and it is the JAX package's within
    fp32 summation order."""
    params, jcfg, model = jax_twin
    i1, i2 = padded(pair)
    state = raft_stereo_prepare(model, torch.from_numpy(i1), torch.from_numpy(i2))
    new_state, dnorm = raft_stereo_segment_carry(model, state, iters=2)
    expect = (new_state["coords1"] - state["coords1"]).abs()[..., 0].mean().item() / 2
    assert dnorm.shape == (1,) and dnorm.dtype == torch.float32
    assert float(dnorm[0]) == pytest.approx(expect, rel=1e-6)
    (jstate,) = jax.jit(jax_build_program("prepare", jcfg, 0))(params, i1, i2)
    _, _, jdnorm = jax.jit(jax_build_program("advance", jcfg, 2))(params, jstate)
    np.testing.assert_allclose(dnorm.numpy(), np.asarray(jdnorm), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Serving: first-frame parity, honest labels, deck/usage/counter joins.
# ---------------------------------------------------------------------------


def test_stream_first_frame_bitwise_stateless_and_warm_converges(bsvc, pair):
    session = bsvc.session
    l, r = pair
    f1 = bsvc.submit({"id": "f1", "left": l, "right": r, "stream": "cam-a"}).result(timeout=300)
    ref = bsvc.submit({"id": "ref", "left": l, "right": r}).result(timeout=300)
    assert f1["status"] == ref["status"] == "ok"
    assert f1["quality"] == "full"
    assert f1["disparity"].tobytes() == ref["disparity"].tobytes()

    # Frame 2 warm-starts (same padded bucket) and, with an absurdly loose
    # tolerance, exits at the FIRST segment boundary: converged:k with k
    # the iterations run.
    f2 = bsvc.submit({"id": "f2", "left": l, "right": r, "stream": "cam-a",
                      "converge_tol": 1e9}).result(timeout=300)
    assert f2["status"] == "ok"
    assert f2["quality"] == "converged:2" and f2["iters"] == 2

    st = bsvc.status()["stream"]
    assert st["warm_joins"] >= 1 and st["converged_exits"] >= 1

    # The deck's tick rows count warm joins and converged exits, the
    # program counters have a prepare_warm series, the usage rollup
    # attributes the stream events to the tenant. The Future resolves
    # inside the tick (before end_tick publishes it): poll briefly.
    for _ in range(500):
        ticks = session.deck.snapshot()
        if sum(t.get("warm_joins", 0) for t in ticks) >= 1 and \
                sum(t.get("converged", 0) for t in ticks) >= 1:
            break
        time.sleep(0.01)
    assert sum(t.get("warm_joins", 0) for t in ticks) >= 1
    assert sum(t.get("converged", 0) for t in ticks) >= 1
    kinds = {labels["kind"] for labels, _ in bsvc.registry.series("raft_program_calls_total")}
    assert "prepare_warm" in kinds
    usage = session.usage.doc()
    assert usage["by_tenant"]["default"]["stream"]["warm_joins"] >= 1
    assert usage["by_tenant"]["default"]["stream"]["converged_exits"] >= 1

    # The warm row's spans carry the prepare_warm kind with a tick link.
    trace = None
    for t in session.tracer.timelines():
        if t.get("request_id") == "f2":
            trace = t
    assert trace is not None
    warm_spans = [s for s in trace["spans"] if s["kind"] == "prepare_warm"]
    assert warm_spans and warm_spans[0].get("attrs", {}).get("tick") is not None


def test_sequential_stream_path_warm_join(tiny_params, tiny_cfg, pair):
    session = make_session(tiny_params, tiny_cfg)
    svc = StereoService(session, ServiceConfig(max_queue=4, workers=1)).start()
    try:
        l, r = pair
        f1 = svc.handle({"id": "f1", "left": l, "right": r, "stream": "cam-s"})
        ref = svc.handle({"id": "ref", "left": l, "right": r})
        assert f1["status"] == "ok"
        assert f1["disparity"].tobytes() == ref["disparity"].tobytes()
        f2 = svc.handle({"id": "f2", "left": l, "right": r, "stream": "cam-s",
                         "converge_tol": 1e9})
        assert f2["quality"] == "converged:2" and f2["iters"] == 2
        st = svc.status()["stream"]
        assert st["warm_joins"] == 1 and st["converged_exits"] == 1
    finally:
        svc.stop()
    # Sessions die on stop.
    assert svc.stream.status()["sessions"] == 0


def test_stream_runner_first_frame_parity(tiny_params, tiny_cfg, pair):
    """demo --video's first frame is bit for bit the single-pair path."""
    session = make_session(tiny_params, tiny_cfg)
    runner = StreamRunner(session)
    l, r = pair
    out = runner.infer(l, r)
    ref = session.infer(l, r)
    assert out.quality == "full"
    assert out.disparity.tobytes() == ref.disparity.tobytes()
    assert len(runner.last.dnorms) == 2 and not runner.last.warm
    # Frame 2 warm-starts; with the tolerance forced loose it converges
    # with the honest label.
    runner.converge_tol = 1e9
    out2 = runner.infer(l, r)
    assert out2.quality == "converged:2" and out2.iters == 2
    assert runner.warm_frames == 1 and runner.last.warm


# ---------------------------------------------------------------------------
# Session table: bounds under churn, TTL, bounce re-admission — each driven
# identically on both packages' StreamManager.
# ---------------------------------------------------------------------------


def _jax_host_session(clock=None):
    """What the JAX StreamManager reads of its session (registry, clock,
    usage, padder), without a model: the table semantics are host code."""
    registry = JaxRegistry()
    return types.SimpleNamespace(
        registry=registry, clock=clock or JaxFakeClock(), usage=JaxUsage(registry),
        padder_for=lambda shape: JaxPadder(shape, divis_by=32, bucket=32))


def _admitted(manager, pair, tenant, sid):
    left, right = pair
    req = {"left": left, "right": right, "tenant": tenant, "stream": sid}
    manager.admit(req)
    return req


def _both(tiny_params, tiny_cfg, port_clock=None, jax_clock=None, **kw):
    session = make_session(tiny_params, tiny_cfg, clock=port_clock)
    jsession = _jax_host_session(jax_clock)
    return ((StreamManager(session, **kw), session.registry),
            (jax_stream.StreamManager(jsession, **kw), jsession.registry))


def test_session_storm_cannot_grow_table_or_metrics(tiny_params, tiny_cfg, pair):
    """A 200-session storm past the cap leaves the table at its cap and
    /metrics flat (stream counters are global or by the bounded tenant
    label, never by session id); both packages end in the same state."""
    l, r = canonical(pair)
    statuses = []
    for manager, registry in _both(tiny_params, tiny_cfg, max_sessions=8, per_tenant=4):
        for i in range(20):
            _admitted(manager, (l, r), f"t-{i % 3}", f"cam-{i}")
        lines_before = registry.render_prometheus().count("\n")
        for i in range(20, 200):
            _admitted(manager, (l, r), f"t-{i % 3}", f"cam-{i}")
        lines_after = registry.render_prometheus().count("\n")
        st = manager.status()
        assert st["sessions"] <= 8
        assert all(v <= 4 for v in st["per_tenant"].values())
        assert st["evicted"] >= 190
        assert lines_after == lines_before, (
            "session churn grew /metrics — a label leaked per session id")
        statuses.append(st)
    assert statuses[0] == statuses[1]


def test_per_tenant_cap_cannot_displace_other_tenants(tiny_params, tiny_cfg, pair):
    l, r = canonical(pair)
    statuses = []
    for manager, _ in _both(tiny_params, tiny_cfg, max_sessions=16, per_tenant=2):
        _admitted(manager, (l, r), "victim", "cam-0")
        for i in range(50):  # one hostile tenant churning session names
            _admitted(manager, (l, r), "hog", f"cam-{i}")
        st = manager.status()
        assert st["per_tenant"].get("hog", 0) <= 2
        assert st["per_tenant"].get("victim") == 1, (
            "a tenant at its own cap displaced another tenant's session")
        statuses.append(st)
    assert statuses[0] == statuses[1]


def test_ttl_expiry_and_midflight_deposit_drop(tiny_params, tiny_cfg, pair):
    clock, jclock = FakeClock(), JaxFakeClock()
    l, r = canonical(pair)
    statuses = []
    for (manager, _), clk in zip(_both(tiny_params, tiny_cfg, port_clock=clock,
                                       jax_clock=jclock, ttl_ms=1000.0), (clock, jclock)):
        req = _admitted(manager, (l, r), "t", "cam")
        assert manager.status()["sessions"] == 1
        # The frame is in flight when the TTL expires...
        clk.sleep(2.0)
        req["_stream_flow"] = np.zeros((1, 8, 8, 1), np.float32)
        req["_stream_shape"] = (64, 64)
        manager.deposit(req, {"status": "ok"})
        st = manager.status()
        # ...so the deposit lands as a counted drop, never a resurrection.
        assert st["sessions"] == 0
        assert st["expired"] == 1 and st["deposits_dropped"] == 1
        # The next frame of that stream simply starts cold.
        req2 = _admitted(manager, (l, r), "t", "cam")
        assert req2.get("_flow_init") is None
        assert manager.status()["sessions"] == 1
        statuses.append(manager.status())
    assert statuses[0] == statuses[1]


def test_bounce_harvest_keeps_warm_seed(tiny_params, tiny_cfg, pair):
    """The held seed rides the REQUEST dict, so a generation bounce's
    harvest and re-admission keep the row warm: the re-admitted row runs
    prepare_warm (counted), not a cold prepare."""
    session = make_session(tiny_params, tiny_cfg, max_batch=2)
    manager = StreamManager(session)
    l, r = canonical(pair)
    f = tiny_cfg.downsample_factor
    ph, pw = session.padder_for(l.shape).padded_shape
    flow = np.zeros((1, ph // f, pw // f, 1), np.float32)

    responses = []
    sched = BatchScheduler(session, resolve=lambda rq, rs: responses.append(rs),
                           stream=manager)
    req = {"id": "warm", "left": l, "right": r, "_flow_init": flow,
           "_converge_tol": 1e9, "_stream": ("t", "cam")}
    sched.submit(req)
    # A generation bounce before any tick ran: defunct + harvest.
    sched.defunct = True
    harvested = sched.harvest()
    assert harvested == [req]
    assert harvested[0].get("_flow_init") is not None, "harvest dropped the warm seed"
    sched.shutdown()

    # Re-admission into a fresh generation stays warm.
    sched2 = BatchScheduler(session, resolve=lambda rq, rs: responses.append(rs),
                            stream=manager, generation=1)
    sched2.submit(req)
    before = int(session.registry.value("raft_stream_warm_joins_total"))
    for _ in range(2000):
        if responses:
            break
        if not sched2.run_tick():
            time.sleep(0.002)
    assert responses and responses[0]["status"] == "ok"
    assert responses[0]["quality"] == "converged:2"
    assert "_stream_flow" in req and req["_stream_shape"] == (ph, pw)
    after = int(session.registry.value("raft_stream_warm_joins_total"))
    assert after == before + 1
    sched2.shutdown()


def test_mixed_cold_and_warm_joiners_share_one_batch(tiny_params, tiny_cfg, pair):
    """Warm and cold rows prepare through different programs but advance in
    ONE batch, and the warm row's result is bit for bit the same warm
    request in another batch composition of the same bucket."""
    session = make_session(tiny_params, tiny_cfg, max_batch=4)
    l, r = canonical(pair)
    f = tiny_cfg.downsample_factor
    ph, pw = session.padder_for(l.shape).padded_shape
    flow = np.random.default_rng(9).uniform(-1, 1, (1, ph // f, pw // f, 1)).astype(np.float32)

    def run(requests):
        out = {}
        sched = BatchScheduler(session, resolve=lambda rq, rs: out.__setitem__(rq["id"], rs))
        for rq in requests:
            sched.submit(rq)
        # All joiners land in ONE tick (the same batch bucket both runs;
        # across bucket widths the pin is the canary band).
        for bucket in sched._buckets.values():
            for row in list(bucket.pending):
                assert row.uploaded.wait(timeout=30)
        for _ in range(4000):
            if len(out) == len(requests):
                break
            if not sched.run_tick():
                time.sleep(0.002)
        sched.shutdown()
        assert len(out) == len(requests)
        return out

    def warm_req():
        return {"id": "w", "left": l, "right": r, "_flow_init": flow.copy()}

    def cold_req(i, rid=None):
        return {"id": rid or f"c{i}", "left": l, "right": r}

    calls = lambda: {labels["kind"]: v for labels, v in  # noqa: E731
                     session.registry.series("raft_program_calls_total")}
    before = calls()
    # Both runs advance at batch bucket 4 (batch_bucket(3) == batch_bucket(4)
    # == 4) with different batch compositions.
    a = run([warm_req(), cold_req(0), cold_req(1)])
    grew = {k: v - before.get(k, 0) for k, v in calls().items()}
    # One tick joins all three (a prepare and a prepare_warm call) and
    # advances; the next advances and exits them.
    assert grew["prepare"] == 1 and grew["prepare_warm"] == 1 and grew["advance"] == 2
    b = run([warm_req(), cold_req(2), cold_req(3), cold_req(4)])
    assert a["w"]["status"] == b["w"]["status"] == "ok"
    assert a["w"]["disparity"].tobytes() == b["w"]["disparity"].tobytes()
    # A cold row's bytes do not depend on whether a warm row rode beside
    # it (same bucket, same live-row count).
    c = run([cold_req(0), cold_req(5), cold_req(6)])
    assert a["c0"]["disparity"].tobytes() == c["c0"]["disparity"].tobytes()
    # The warm row genuinely warm-started.
    assert a["w"]["disparity"].tobytes() != a["c0"]["disparity"].tobytes()


# ---------------------------------------------------------------------------
# Knob resolution: the same answers and named errors as the JAX resolvers.
# ---------------------------------------------------------------------------


def test_knob_resolution_named_errors(monkeypatch):
    for mod in (pt_stream, jax_stream):
        monkeypatch.setenv("RAFT_STREAM_SESSIONS", "nope")
        with pytest.raises(ValueError, match="RAFT_STREAM_SESSIONS"):
            mod.resolve_stream_sessions()
        monkeypatch.setenv("RAFT_STREAM_SESSIONS", "0")
        with pytest.raises(ValueError, match="RAFT_STREAM_SESSIONS"):
            mod.resolve_stream_sessions()
        monkeypatch.setenv("RAFT_STREAM_SESSIONS", "32")
        assert mod.resolve_stream_sessions() == 32
        assert mod.resolve_stream_sessions(4) == 4

        monkeypatch.setenv("RAFT_STREAM_TTL_MS", "-5")
        with pytest.raises(ValueError, match="RAFT_STREAM_TTL_MS"):
            mod.resolve_stream_ttl_ms()
        monkeypatch.setenv("RAFT_STREAM_TTL_MS", "2500")
        assert mod.resolve_stream_ttl_ms() == 2500.0

        monkeypatch.setenv("RAFT_CONVERGE_TOL", "junk")
        with pytest.raises(ValueError, match="RAFT_CONVERGE_TOL"):
            mod.resolve_converge_tol()
        monkeypatch.setenv("RAFT_CONVERGE_TOL", "-0.1")
        with pytest.raises(ValueError, match="RAFT_CONVERGE_TOL"):
            mod.resolve_converge_tol()
        monkeypatch.setenv("RAFT_CONVERGE_TOL", "0.25")
        assert mod.resolve_converge_tol() == 0.25
        monkeypatch.delenv("RAFT_CONVERGE_TOL")
        assert mod.resolve_converge_tol() == 0.01
