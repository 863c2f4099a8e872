"""The port's request service (serve/service.py) and its supervision
(serve/supervise.py) on the CPU.

Mirrors the JAX package's service cases (tests/test_serve.py: ok and
health, rejection before queueing, backpressure, stop draining queued
Futures, a deadline expiring in the queue, the fault storm) and its
supervision battery (tests/test_supervise.py: the watchdog's deadline math,
uploader crashes, device hangs, tick crashes, flight records across a
bounce, stop racing a tick, the drain), with the tiny model, ``device="cpu"``
and a ``FakeClock``. No Supervisor monitor thread runs: every test drives
``Supervisor.check_now()`` itself. The service's stream and cache knobs
resolve (explicit, env, default), and a request's stream fields warm-start
it (tests/test_torch_stream_serve.py and tests/test_torch_cache.py hold the
rest of those modules).
"""

import time

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo
from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
from raft_stereo_tpu_torch.faults import ChaosPlan, FakeClock, ServeFaultPlan, malformed_pairs
from raft_stereo_tpu_torch.obs.flight import FlightRecorder
from raft_stereo_tpu_torch.serve import (InferenceSession, ServiceConfig, SessionConfig,
                                         StereoService, Supervisor)
from raft_stereo_tpu_torch.serve.supervise import (DEFAULT_DRAIN_GRACE_MS,
                                                   DEFAULT_RETRY_BUDGET, WATCHDOG_FACTOR,
                                                   WATCHDOG_WARM_FACTOR, InFlight,
                                                   InvocationWatch, resolve_drain_grace_ms,
                                                   resolve_retry_budget, resolve_watchdog_ms)

pytestmark = pytest.mark.serve

TINY = dict(n_gru_layers=1, hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
H, W = 40, 60  # not multiples of 32: every request really is padded
LADDER_NAMES = ("fuse_iter", "lane_pack8", "corr_pack8", "fuse_gru1632", "stream_tail",
                "corr_kernel", "fused_encoders", "fused_update")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    for knob in ENV_KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def tiny_cfg():
    return RAFTStereoConfig(**TINY)


@pytest.fixture(scope="module")
def tiny_params(tiny_cfg):
    """The port's model (the JAX battery's fixture name kept)."""
    return init_raft_stereo(tiny_cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 255, (H, W, 3)).astype(np.float32),
            rng.uniform(0, 255, (H, W, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(7)
    return [(rng.uniform(0, 255, (H, W, 3)).astype(np.float32)[None],
             rng.uniform(0, 255, (H, W, 3)).astype(np.float32)[None])
            for _ in range(4)]


def make_session(params, cfg, *, valid_iters=4, segments=2, plan=None,
                 clock=None, **kw):
    scfg = SessionConfig(valid_iters=valid_iters, segments=segments,
                         canary=kw.pop("canary", False), **kw)
    return InferenceSession(params, cfg, scfg, device="cpu", fault_plan=plan,
                            clock=clock or FakeClock())


def make_service(params, cfg, *, plan=None, flight=None, retry_budget=2,
                 watchdog_ms=5000.0, max_queue=16):
    """Batched service with supervision config but NO monitor thread:
    tests drive ``check_now`` by hand for deterministic ordering."""
    session = InferenceSession(
        params, cfg,
        SessionConfig(valid_iters=4, segments=2, max_batch=4,
                      canary=False),
        device="cpu", fault_plan=plan, clock=FakeClock(), flight=flight)
    svc = StereoService(session, ServiceConfig(
        max_queue=max_queue, watchdog_ms=watchdog_ms,
        retry_budget=retry_budget, supervise=False)).start()
    return session, svc


def wait_real(predicate, timeout=30.0, what="condition"):
    """Bounded real-time rendezvous with an injected thread death (the
    deadline MATH stays on FakeClock; this only waits for the OS to run
    the victim thread)."""
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.002)


def submit(svc, pairs, rid, **kw):
    left, right = pairs[rid % len(pairs)]
    return svc.submit({"id": rid, "left": left, "right": right, **kw})


# ---------------------------------------------------------------------------
# The request service (tests/test_serve.py's service cases).


def test_service_ok_and_health(tiny_params, tiny_cfg, pair):
    sess = make_session(tiny_params, tiny_cfg)
    with StereoService(sess, ServiceConfig(max_queue=4, workers=1)) as svc:
        resp = svc.submit({"id": "r1", "left": pair[0],
                           "right": pair[1]}).result()
    assert resp["status"] == "ok" and resp["id"] == "r1"
    assert resp["quality"] == "full"
    assert np.isfinite(resp["disparity"]).all()
    st = svc.status()
    assert st["requests"]["ok"] == 1
    assert st["latency_ms"]["n"] == 1
    assert st["session"]["breaker"]["trip_count"] == 0


def test_service_rejects_malformed_before_queueing(tiny_params, tiny_cfg):
    sess = make_session(tiny_params, tiny_cfg)
    bad = malformed_pairs(h=H, w=W)["five_channel"]
    svc = StereoService(sess)  # not started: validation is synchronous
    resp = svc.submit({"left": bad[0], "right": bad[1]}).result()
    assert resp["status"] == "rejected"
    assert resp["code"] == "invalid_input:bad_channels"
    assert sess.metrics()["compiles"] == 0  # never touched a device


def test_service_queue_full_backpressure(tiny_params, tiny_cfg, pair):
    """One busy worker + depth-1 queue: the third concurrent request gets
    an immediate structured queue_full rejection."""
    import threading
    import time

    class GateClock:
        """Real monotonic clock whose injected 'slowness' blocks on an
        event the test releases — the worker is provably busy while the
        backpressure assertions run, with zero timing sensitivity."""

        def __init__(self):
            self.gate = threading.Event()

        @staticmethod
        def now():
            return time.monotonic()

        def sleep(self, _seconds):
            assert self.gate.wait(timeout=30)

    clk = GateClock()
    sess = make_session(tiny_params, tiny_cfg, clock=clk,
                        plan=ServeFaultPlan(
                            slow_forwards={1: 1.0, 2: 1.0}))
    sess.infer(*pair)  # pre-compile; consumes forward ordinal 0
    with StereoService(sess, ServiceConfig(max_queue=1, workers=1)) as svc:
        f1 = svc.submit({"id": 1, "left": pair[0], "right": pair[1]})
        # wait until the worker has f1's forward done and is parked in
        # the injected slowness (ordinal 1 consumed)
        for _ in range(3000):
            if sess.faults.forwards >= 2:
                break
            time.sleep(0.01)
        f2 = svc.submit({"id": 2, "left": pair[0], "right": pair[1]})
        f3 = svc.submit({"id": 3, "left": pair[0], "right": pair[1]})
        resp3 = f3.result(timeout=5)   # rejected synchronously at submit
        clk.gate.set()                 # release the worker
        statuses = {f.result(timeout=30)["id"]: f.result()
                    for f in (f1, f2)}
    assert resp3["status"] == "rejected"
    assert resp3["code"] == "queue_full"
    assert statuses[1]["status"] == "ok"
    assert statuses[2]["status"] == "ok"
    assert svc.status()["requests"]["rejected:queue_full"] == 1


def test_service_stop_drains_queued_futures(tiny_params, tiny_cfg, pair):
    """stop() must resolve still-queued Futures with a structured
    rejection — an abandoned Future deadlocks its caller forever."""
    import threading
    import time

    class GateClock:
        def __init__(self):
            self.gate = threading.Event()

        @staticmethod
        def now():
            return time.monotonic()

        def sleep(self, _seconds):
            assert self.gate.wait(timeout=30)

    clk = GateClock()
    sess = make_session(tiny_params, tiny_cfg, clock=clk,
                        plan=ServeFaultPlan(slow_forwards={1: 1.0}))
    sess.infer(*pair)  # pre-compile; consumes forward ordinal 0
    svc = StereoService(sess, ServiceConfig(max_queue=4, workers=1)).start()
    f1 = svc.submit({"id": 1, "left": pair[0], "right": pair[1]})
    for _ in range(3000):  # worker parked in f1's injected slowness
        if sess.faults.forwards >= 2:
            break
        time.sleep(0.01)
    f2 = svc.submit({"id": 2, "left": pair[0], "right": pair[1]})
    clk.gate.set()
    stopper = threading.Thread(target=svc.stop)
    stopper.start()
    r2 = f2.result(timeout=30)
    stopper.join(timeout=30)
    assert f1.result(timeout=30)["status"] == "ok"
    # f2 either ran (worker dequeued it before exiting) or was drained
    # with the structured stop rejection — never left unresolved.
    assert r2["status"] in ("ok", "rejected")
    if r2["status"] == "rejected":
        assert r2["code"] == "service_stopped"


def test_service_deadline_expires_in_queue(tiny_params, tiny_cfg, pair):
    """A request whose deadline passes while queued is rejected on
    dequeue without touching the device."""
    clk = FakeClock()
    sess = make_session(tiny_params, tiny_cfg, clock=clk)
    svc = StereoService(sess)
    req = {"left": pair[0], "right": pair[1], "deadline_ms": 1000.0}
    assert svc._admit(req) is None
    clk.sleep(2.0)  # deadline passes while "queued"
    resp = svc._respond(req)
    assert resp["status"] == "rejected"
    assert resp["code"] == "deadline_exceeded_in_queue"


# ---------------------------------------------------------------------------
# The fault storm (release-gate acceptance): compile failures + deadline
# overruns + malformed inputs interleaved into one request stream; the
# session must never crash, every response must be a valid labeled
# disparity or a structured rejection, and the breaker must end at its
# bottom rung with all trips recorded.


def test_fault_storm(tiny_params):
    cfg = RAFTStereoConfig(**{**TINY, "corr_implementation": "reg_cuda"})
    clk = FakeClock()
    plan = ServeFaultPlan(
        # first builds: the first request's program walks the whole ladder
        compile_errors={i: ("mosaic" if i == 1 else "oom")
                        for i in range(len(LADDER_NAMES))},
        # ordinal 0: request 1's forward; 1-3: request 3's prepare/segments
        slow_forwards={2: 100.0},
    )
    sess = make_session(tiny_params, cfg, plan=plan, clock=clk)
    svc = StereoService(sess, ServiceConfig(max_queue=8, workers=1))
    rng = np.random.default_rng(3)

    def good():
        return (rng.uniform(0, 255, (H, W, 3)).astype(np.float32),
                rng.uniform(0, 255, (H, W, 3)).astype(np.float32))

    bad = malformed_pairs(h=H, w=W)
    g1, g2, g3, g4 = good(), good(), good(), good()
    stream = [
        {"id": "ok-1", "left": g1[0], "right": g1[1]},
        {"id": "nan", "left": bad["nan_pixels"][0],
         "right": bad["nan_pixels"][1]},
        {"id": "deadline", "left": g2[0], "right": g2[1],
         "deadline_ms": 50_000.0},
        {"id": "channels", "left": bad["five_channel"][0],
         "right": bad["five_channel"][1]},
        {"id": "zero", "left": bad["zero_area"][0],
         "right": bad["zero_area"][1]},
        {"id": "ok-2", "left": g3[0], "right": g3[1]},
        {"id": "mismatch", "left": bad["mismatched_shapes"][0],
         "right": bad["mismatched_shapes"][1]},
        {"id": "deadline-2", "left": g4[0], "right": g4[1],
         "deadline_ms": 1e9},
    ]
    responses = {r["id"]: svc.handle(r) for r in stream}

    # zero crashes: every response is structured
    assert all(r["status"] in ("ok", "rejected", "error")
               for r in responses.values())
    # honest quality labels on every served frame
    assert responses["ok-1"]["status"] == "ok"
    assert responses["ok-1"]["quality"] == "full"
    assert responses["deadline"]["status"] == "ok"
    assert responses["deadline"]["quality"] == "reduced_iters:2"
    assert responses["deadline"]["deadline_missed"]
    assert responses["ok-2"]["quality"] == "full"
    assert responses["deadline-2"]["quality"] == "full"
    for rid in ("ok-1", "deadline", "ok-2", "deadline-2"):
        assert np.isfinite(responses[rid]["disparity"]).all()
    # structured rejections with the right codes
    assert responses["nan"]["code"] == "invalid_input:nonfinite_input"
    assert responses["channels"]["code"] == "invalid_input:bad_channels"
    assert responses["zero"]["code"] == "invalid_input:zero_area"
    assert responses["mismatch"]["code"] == "invalid_input:shape_mismatch"
    # the breaker ladder ended at its bottom rung with all trips recorded
    assert sess.breaker.exhausted
    assert sess.breaker.tripped_names == LADDER_NAMES
    assert sess._run_cfg.corr_implementation == "reg"
    # health reflects the storm
    st = svc.status()
    assert st["requests"]["ok"] == 4
    assert st["requests"]["degraded"] == 1
    assert st["session"]["breaker"]["trip_count"] == len(LADDER_NAMES)
    assert st["session"]["counts"]["requests_ok"] == 4


# ---------------------------------------------------------------------------
# Watchdog deadline math (pure, FakeClock-free).


def test_watchdog_deadline_math():
    """Steady = max(EMA x factor, floor); EMA-less steady = floor alone;
    warming (compile-inclusive) = floor x warm grace, never the EMA rule."""
    def inv(warming, est):
        return InFlight(token=0, program="p", kind="advance",
                        warming=warming, est=est, t0=0.0)
    floor = 2.0
    assert InvocationWatch.allowed_s(inv(False, None), floor) == floor
    assert InvocationWatch.allowed_s(inv(False, 10.0), floor) == \
        10.0 * WATCHDOG_FACTOR
    assert InvocationWatch.allowed_s(inv(False, 0.1), floor) == floor
    assert InvocationWatch.allowed_s(inv(True, 0.1), floor) == \
        floor * WATCHDOG_WARM_FACTOR


def test_invocation_watch_overdue_on_fake_clock():
    clk = FakeClock()
    watch = InvocationWatch(clk)
    token = watch.begin("prog", "advance", warming=False, est=None)
    assert watch.count == 1
    assert watch.overdue(clk.now(), 5.0) == []
    clk.sleep(50.0)
    rows = watch.overdue(clk.now(), 5.0)
    assert len(rows) == 1
    inv, age, allowed = rows[0]
    assert inv.kind == "advance" and age == 50.0 and allowed == 5.0
    watch.end(token)
    assert watch.count == 0 and watch.overdue(clk.now(), 5.0) == []


def test_supervision_knobs_resolve_env(monkeypatch):
    """Explicit config > env knob > default — the SERVE_ENV_KNOBS
    contract for all three supervision knobs."""
    for name in ("RAFT_WATCHDOG_MS", "RAFT_RETRY_BUDGET",
                 "RAFT_DRAIN_GRACE_MS"):
        monkeypatch.delenv(name, raising=False)
    assert resolve_watchdog_ms() == 0.0          # library default: off
    assert resolve_retry_budget() == DEFAULT_RETRY_BUDGET
    assert resolve_drain_grace_ms() == DEFAULT_DRAIN_GRACE_MS
    monkeypatch.setenv("RAFT_WATCHDOG_MS", "1234")
    monkeypatch.setenv("RAFT_RETRY_BUDGET", "7")
    monkeypatch.setenv("RAFT_DRAIN_GRACE_MS", "2500")
    assert resolve_watchdog_ms() == 1234.0
    assert resolve_retry_budget() == 7
    assert resolve_drain_grace_ms() == 2500.0
    assert resolve_watchdog_ms(10.0) == 10.0     # explicit beats env
    assert resolve_retry_budget(0) == 0
    assert resolve_drain_grace_ms(1.0) == 1.0


# ---------------------------------------------------------------------------
# Satellite bugfix pin: a mid-run uploader crash must never strand its
# joiners' Futures — structured ``upload_failed``, retries recorded, and
# the watchdog bounce restores service on a fresh uploader.


def test_uploader_crash_is_structured_upload_failed(tiny_params, tiny_cfg,
                                                    pairs):
    session, svc = make_service(tiny_params, tiny_cfg,
                                plan=ChaosPlan(crash_uploads=(0,)),
                                retry_budget=0)
    try:
        r = submit(svc, pairs, 0).result(timeout=60)
        assert r["status"] == "error" and r["code"] == "upload_failed"
        hb = svc.supervision_status()["heartbeats"]
        assert hb["uploader_dead"] is not None
        # The watchdog heals it: uploader_dead trip -> generation bounce
        # -> fresh uploader -> the next request serves clean.
        sup = Supervisor(svc, watchdog_s=5.0)
        trips = sup.check_now()
        assert [t.kind for t in trips] == ["uploader_dead"]
        r2 = submit(svc, pairs, 1).result(timeout=60)
        assert r2["status"] == "ok" and r2["quality"] == "full"
        st = svc.supervision_status()
        assert st["generation"] == 2
        assert st["restarts"] == {"uploader_dead": 1}
    finally:
        svc.stop()


def test_uploader_crash_burns_bounded_retries(tiny_params, tiny_cfg, pairs):
    """Without a bounce, every re-admission meets the same dead uploader:
    the budget bounds the loop and the final response records it
    (``retries: k`` — the response contract)."""
    session, svc = make_service(tiny_params, tiny_cfg,
                                plan=ChaosPlan(crash_uploads=(0,)),
                                retry_budget=3)
    try:
        r = submit(svc, pairs, 0).result(timeout=60)
        assert r["status"] == "error" and r["code"] == "upload_failed"
        assert r["retries"] == 3
        assert int(session.registry.value(
            "raft_request_retries_total")) == 3
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# Acceptance pin: injected device hang provably recovers — watchdog
# fires, the generation bounces, the request retries inside its budget
# (success) or fails ``device_hang`` (budget exhausted).  FakeClock: the
# 50 s hang costs zero wall time in the deadline math.


def hang_service(tiny_params, tiny_cfg, *, retry_budget):
    # Invoke ordinals with one warm request ahead: warm rides
    # prepare(0) advance(1) advance(2) epilogue(3); the victim's steady
    # advance is ordinal 5 — a STEADY hang, governed by the floor, not
    # the warm grace.
    plan = ChaosPlan(hang_invokes={5: 50.0}, hang_cap_s=20.0)
    return make_service(tiny_params, tiny_cfg, plan=plan,
                        retry_budget=retry_budget)


def test_device_hang_recovers_within_budget(tiny_params, tiny_cfg, pairs):
    session, svc = hang_service(tiny_params, tiny_cfg, retry_budget=2)
    try:
        warm = submit(svc, pairs, 0).result(timeout=120)
        assert warm["status"] == "ok"
        fut = submit(svc, pairs, 1)
        assert session.faults.wait_hang_entered(1, timeout=30)
        sup = Supervisor(svc, watchdog_s=5.0)
        trips = sup.check_now()
        assert [t.kind for t in trips] == ["device_hang"]
        r = fut.result(timeout=60)
        assert r["status"] == "ok" and r["quality"] == "full"
        assert r["retries"] == 1   # the bounce re-admission, recorded
        st = svc.supervision_status()
        assert st["generation"] == 2
        assert st["restarts"] == {"device_hang": 1}
        assert st["watchdog_trips"] == {"device_hang": 1}
        # /healthz carries the supervision block end to end.
        assert svc.status()["supervision"]["generation"] == 2
    finally:
        svc.stop()


def test_device_hang_budget_exhausted_fails_device_hang(tiny_params,
                                                        tiny_cfg, pairs):
    session, svc = hang_service(tiny_params, tiny_cfg, retry_budget=0)
    try:
        assert submit(svc, pairs, 0).result(timeout=120)["status"] == "ok"
        fut = submit(svc, pairs, 1)
        assert session.faults.wait_hang_entered(1, timeout=30)
        Supervisor(svc, watchdog_s=5.0).check_now()
        r = fut.result(timeout=60)
        assert r["status"] == "error" and r["code"] == "device_hang"
        assert "retries" not in r   # budget 0: no re-admission happened
    finally:
        svc.stop()


def test_real_hang_trips_once_not_every_sweep(tiny_params, tiny_cfg):
    """A REAL device hang never calls watch.end(): without trip memory
    every sweep would re-detect it and bounce each fresh, healthy
    generation in a poll-period storm. One hang = one bounce."""
    session, svc = make_service(tiny_params, tiny_cfg)
    try:
        token = session.watch.begin("prog", "advance", warming=False,
                                    est=None)
        session.clock.sleep(60.0)
        sup = Supervisor(svc, watchdog_s=5.0)
        assert [t.kind for t in sup.check_now()] == ["device_hang"]
        assert sup.check_now() == []          # same wedged invocation
        assert sup.check_now() == []
        st = svc.supervision_status()
        assert st["generation"] == 2          # exactly ONE bounce
        assert st["restarts"] == {"device_hang": 1}
        # The invocation ending clears the memory: a NEW hang trips.
        session.watch.end(token)
        session.watch.begin("prog", "advance", warming=False, est=None)
        session.clock.sleep(60.0)
        assert [t.kind for t in sup.check_now()] == ["device_hang"]
        assert svc.supervision_status()["generation"] == 3
    finally:
        svc.stop()


def test_wedged_uploader_trips_stalled(tiny_params, tiny_cfg):
    """An uploader wedged mid-transfer (alive, not dead) is otherwise
    invisible — the tick loop keeps beating while nothing uploads; the
    busy_since age detector bounces onto a fresh uploader."""
    session, svc = make_service(tiny_params, tiny_cfg)
    try:
        svc._scheduler.uploader.busy_since = session.clock.now()
        session.clock.sleep(60.0)   # > floor(5) x stall_factor(4)
        sup = Supervisor(svc, watchdog_s=5.0)
        assert [t.kind for t in sup.check_now()] == ["uploader_stalled"]
        st = svc.supervision_status()
        assert st["generation"] == 2
        assert st["restarts"] == {"uploader_stalled": 1}
        assert sup.check_now() == []   # fresh uploader: not busy
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# Acceptance pin: injected tick-loop crash provably recovers — the loop
# wrapper records the death on the heartbeat, the watchdog bounces the
# generation, the stranded mid-batch row re-admits and serves.


def test_tick_crash_recovers(tiny_params, tiny_cfg, pairs):
    # Work ticks are deterministic (idle polls don't count): request 0
    # consumes ticks 0-1; the crash after tick 2 kills the loop with
    # request 1 mid-batch (joined + one segment advanced).
    session, svc = make_service(tiny_params, tiny_cfg,
                                plan=ChaosPlan(crash_ticks=(2,)),
                                retry_budget=2)
    try:
        assert submit(svc, pairs, 0).result(timeout=120)["status"] == "ok"
        fut = submit(svc, pairs, 1)
        wait_real(lambda: svc._heartbeat.died is not None,
                  what="injected tick crash to kill the loop thread")
        sup = Supervisor(svc, watchdog_s=5.0)
        trips = sup.check_now()
        assert [t.kind for t in trips] == ["tick_crashed"]
        r = fut.result(timeout=60)
        assert r["status"] == "ok" and r["quality"] == "full"
        assert r["retries"] == 1
        st = svc.supervision_status()
        assert st["generation"] == 2
        assert st["restarts"] == {"tick_crashed": 1}
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# Flight-recorder sequence numbering survives a generation bounce: the
# recorder is session-owned (one per lineage, not per generation), so
# bounce records and post-bounce breach records share one monotone
# sequence — eviction order stays oldest-first through a restart storm.


def test_flight_seq_survives_generation_bounce(tiny_params, tiny_cfg,
                                               pairs, tmp_path):
    flight = FlightRecorder(str(tmp_path), limit=16)
    session, svc = make_service(tiny_params, tiny_cfg, flight=flight)
    try:
        assert svc.bounce()
        assert submit(svc, pairs, 0).result(timeout=120)["status"] == "ok"
        assert svc.bounce()
        session.flight.record({"post": True}, trace_id="after")
        paths = flight.records()
        seqs = [int(p.split("flight-")[1][:6]) for p in paths]
        assert seqs == [0, 1, 2]       # monotone across both bounces
        assert "bounce-g2" in paths[0] and "bounce-g3" in paths[1]
        import json
        doc = json.loads(open(paths[0]).read())
        assert doc["reasons"] == ["watchdog:manual"]
        assert doc["generation"] == {"from": 1, "to": 2}
        st = svc.supervision_status()
        assert st["generation"] == 3 and st["restarts"] == {"manual": 2}
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# Exactly-once resolution: stop() racing an in-flight batched tick must
# resolve every admitted row exactly once — no abandoned Future, and the
# outcome counters reconcile (a double resolve would double-count; the
# request-claim guard in the service pins this).


def test_stop_racing_tick_resolves_exactly_once(tiny_params, tiny_cfg,
                                                pairs):
    session = InferenceSession(
        tiny_params, tiny_cfg,
        SessionConfig(valid_iters=4, segments=2, max_batch=4,
                      canary=False),
        device="cpu", clock=FakeClock())
    reg = session.registry

    def outcome_total():
        return sum(int(v) for labels, v in
                   reg.series("raft_requests_total")
                   if labels["outcome"] != "degraded")

    svc = StereoService(session, ServiceConfig(max_queue=16,
                                               supervise=False))
    for round_no in range(3):   # three interleavings of stop vs tick
        before = outcome_total()
        svc.start()
        futs = [submit(svc, pairs, i) for i in range(6)]
        if round_no == 1:
            # Let the scheduler provably reach mid-flight before racing.
            deadline = time.monotonic() + 30
            while svc._scheduler.active_rows == 0 and \
                    time.monotonic() < deadline:
                time.sleep(0.001)
        svc.stop()
        responses = [f.result(timeout=60) for f in futs]
        for r in responses:
            assert r["status"] in ("ok", "rejected"), r
            if r["status"] == "rejected":
                assert r["code"] in ("service_stopped", "not_running")
        assert outcome_total() - before == len(futs), (
            "outcome counters disagree with resolved Futures — a row was "
            "double-resolved or dropped")


def test_queue_depth_gauge_registered(tiny_params, tiny_cfg, pairs):
    session, svc = make_service(tiny_params, tiny_cfg)
    try:
        assert submit(svc, pairs, 0).result(timeout=120)["status"] == "ok"
        assert "raft_queue_depth" in svc.metrics_text()
        assert int(session.registry.value("raft_queue_depth")) == 0
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# Drain contract (library level; the CLI signal path rides these).


def test_drain_rejects_new_and_finishes_admitted(tiny_params, tiny_cfg,
                                                 pairs):
    session, svc = make_service(tiny_params, tiny_cfg)
    try:
        fut = submit(svc, pairs, 0)
        svc.begin_drain()
        late = submit(svc, pairs, 1).result(timeout=10)
        assert late["status"] == "rejected"
        assert late["code"] == "service_draining"
        # Admitted work runs to its exit with an honest label.
        r = fut.result(timeout=120)
        assert r["status"] == "ok" and r["quality"] == "full"
        assert svc.supervision_status()["draining"]
        assert svc.drain(grace_s=30.0)   # quiesces clean -> True
    finally:
        svc.stop()


def test_drain_is_idempotent_and_counts(tiny_params, tiny_cfg, pairs):
    session, svc = make_service(tiny_params, tiny_cfg)
    svc.begin_drain()
    svc.begin_drain()
    r = submit(svc, pairs, 0).result(timeout=10)
    assert r["code"] == "service_draining"
    counts = {labels["outcome"]: int(v) for labels, v in
              session.registry.series("raft_requests_total")}
    assert counts.get("rejected:service_draining") == 1
    svc.stop()


# The stream and cache knobs: explicit config > env knob > default, as the
# JAX service resolves them. (The names are those of the cases that pinned
# these knobs before streams and the cache were ported.)
_SERVICE_KNOBS = {
    # field: (env knob, explicit value, env value, resolved default, how to read it)
    "stream_sessions": ("RAFT_STREAM_SESSIONS", 7, "9", 128,
                        lambda svc: svc.stream.max_sessions),
    "stream_ttl_ms": ("RAFT_STREAM_TTL_MS", 1500.0, "2500", 60_000.0,
                      lambda svc: svc.stream.ttl_s * 1e3),
    "converge_tol": ("RAFT_CONVERGE_TOL", 0.5, "0.25", 0.01,
                     lambda svc: svc.stream.converge_tol),
    "cache_bytes": ("RAFT_CACHE_BYTES", 4096, "8192", 0, lambda svc: svc.cache.max_bytes),
    "cache_ttl_ms": ("RAFT_CACHE_TTL_MS", 1500.0, "2500", 600_000.0,
                     lambda svc: svc.cache.ttl_s * 1e3),
    "cache_near_tol": ("RAFT_CACHE_NEAR_TOL", 3.0, "4.5", 0.0,
                       lambda svc: svc.cache.near_tol),
    "cache_dir": ("RAFT_CACHE_DIR", "explicit", "from-env", None, lambda svc: svc.cache.dir),
}


@pytest.mark.parametrize("knob", ["stream_sessions", "stream_ttl_ms", "converge_tol",
                                  "cache_bytes", "cache_ttl_ms", "cache_near_tol",
                                  "cache_dir"])
def test_unported_service_knobs_raise(knob, tiny_params, tiny_cfg, monkeypatch, tmp_path):
    """Each stream and cache knob resolves at service construction: the
    explicit ServiceConfig value wins, else its RAFT_* env knob, else the
    default; the resolved value is what the stream table or the cache
    uses."""
    env, explicit, from_env, default, read = _SERVICE_KNOBS[knob]
    if knob == "cache_dir":
        explicit, from_env = str(tmp_path / explicit), str(tmp_path / from_env)
    sess = make_session(tiny_params, tiny_cfg)
    monkeypatch.setenv(env, from_env)
    assert read(StereoService(sess, ServiceConfig(**{knob: explicit}))) == explicit
    assert read(StereoService(sess, ServiceConfig())) == type(explicit)(from_env)
    monkeypatch.delenv(env)
    assert read(StereoService(sess, ServiceConfig())) == default


def test_stream_fields_are_served_cold(tiny_params, tiny_cfg, pair):
    """A request's stream and converge_tol fields (the HTTP ingress passes
    them on) take effect: the stream's first frame is served cold and bit
    for bit the stateless response, its next frame warm-starts from it and
    exits at the first segment boundary, converged:2."""
    sess = make_session(tiny_params, tiny_cfg)
    svc = StereoService(sess)
    ref = svc.handle({"id": "a", "left": pair[0], "right": pair[1]})
    first = svc.handle({"id": "b", "left": pair[0], "right": pair[1], "stream": "s1"})
    assert first["status"] == "ok" and first["quality"] == "full"
    assert first["disparity"].tobytes() == ref["disparity"].tobytes()
    resp = svc.handle({"id": "c", "left": pair[0], "right": pair[1], "stream": "s1",
                       "converge_tol": 1e9})
    assert resp["status"] == "ok" and resp["quality"] == "converged:2"
    assert resp["iters"] == 2
    assert svc.status()["stream"]["warm_joins"] == 1
