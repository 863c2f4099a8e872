"""The port's continuous-batching scheduler (serve/scheduler.py) on the CPU.

Mirrors the JAX package's battery (tests/test_batch_serve.py) with its tiny
model (TINY, pairs of 40x60 bucketed to 64x64), ``device="cpu"`` and a
``FakeClock``; the scheduler tests drive ``run_tick`` on the calling
thread, so join and exit ordering is deterministic.

- Within one batch width a row is bit for bit the same whatever its
  batchmates or pad rows; a batched prepare's rows are their B=1 prepares'
  bits (it runs row by row). Across widths (B=1 against B=4) the fp32
  ``F.conv2d`` on the CPU sums in another order at another batch, so those
  comparisons hold to the canary band, as the JAX
  battery's ``assert_rows_match`` does off its strict hosts (on the card,
  ``chip_smoke.CROSS_WIDTH_PIN``).
- Batch buckets, the cache key, the LRU floor, the EMA per batch bucket, the
  batched warm-up.
- The scheduler: parity with the sequential path with pad rows, joins and
  exits at boundaries, per-row deadlines, a deadline expiring in the queue,
  a non-finite output, a failure on a plain rung under the card's breaker
  and a sticky CUDA error, each a structured error on every row.
- The batched service: end to end, backpressure, restart, stop.
- Parity with the JAX package's ``BatchScheduler`` on the same weights,
  fp32: disparities within 1e-4 px, equal labels and keys.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.faults import FakeClock as JaxFakeClock
from raft_stereo_tpu.serve import BatchScheduler as JaxScheduler
from raft_stereo_tpu.serve import InferenceSession as JaxSession
from raft_stereo_tpu.serve import SessionConfig as JaxSessionConfig
from raft_stereo_tpu.transplant.torch_loader import transplant_state_dict

import raft_stereo_tpu_torch.serve.session as session_mod
from raft_stereo_tpu_torch import RAFTStereo, RAFTStereoConfig, init_raft_stereo
from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
from raft_stereo_tpu_torch.faults import FakeClock, ServeFaultPlan
from raft_stereo_tpu_torch.models import (stack_refinement_states, take_refinement_rows)
from raft_stereo_tpu_torch.serve import (BatchScheduler, InferenceSession, KernelCircuitBreaker,
                                         ServiceConfig, SessionConfig, StereoService)
from raft_stereo_tpu_torch.serve.guard import CANARY_ATOL, CANARY_RTOL
from raft_stereo_tpu_torch.serve.validate import AdmissionConfig, validate_pair
from raft_stereo_tpu_torch.transplant import load_state_dict, params_from_jax

pytestmark = pytest.mark.serve

TINY = dict(n_gru_layers=1, hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
H, W = 40, 60  # not multiples of 32: every request really is padded


def assert_rows_match(got, want, what=""):
    """A comparison across batch widths: bit for bit is accepted first,
    else the canary band (fp32 convolutions on the CPU pick their
    summation order by batch)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.tobytes() == want.tobytes():
        return
    assert got.shape == want.shape, what
    assert np.allclose(got, want, rtol=CANARY_RTOL, atol=CANARY_ATOL), (
        f"{what}: drift exceeds the canary band (max |d|={np.max(np.abs(got - want)):.3e})")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    for knob in ENV_KNOBS + ("RAFT_BATCH_BUCKETS",):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def tiny_cfg():
    return RAFTStereoConfig(**TINY)


@pytest.fixture(scope="module")
def tiny_model(tiny_cfg):
    return init_raft_stereo(tiny_cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(7)
    return [(rng.uniform(0, 255, (H, W, 3)).astype(np.float32),
             rng.uniform(0, 255, (H, W, 3)).astype(np.float32)) for _ in range(4)]


def make_session(model, cfg, *, max_batch=4, valid_iters=4, segments=2, plan=None,
                 clock=None, breaker=None, **kw):
    scfg = SessionConfig(valid_iters=valid_iters, segments=segments, max_batch=max_batch,
                         canary=False, **kw)
    return InferenceSession(model, cfg, scfg, device="cpu", fault_plan=plan,
                            clock=clock or FakeClock(), breaker=breaker)


@pytest.fixture(scope="module")
def bsession(tiny_model, tiny_cfg):
    """A shared fault-free batched session (its programs accumulate across
    the read-only tests)."""
    return make_session(tiny_model, tiny_cfg, max_batch=4)


def canonical(pair):
    return validate_pair(pair[0], pair[1], AdmissionConfig())


def make_request(pair, rid=None, deadline=None):
    left, right = canonical(pair)
    return {"id": rid, "left": left, "right": right, "_deadline": deadline}


def drive(sched, out, n_responses, max_spins=2000):
    """Run ticks until n_responses arrived (waits out the uploader)."""
    spins = 0
    while len(out) < n_responses:
        if not sched.run_tick():
            time.sleep(0.002)
        spins += 1
        assert spins < max_spins, "scheduler made no progress"


def wait_uploaded(sched):
    for bucket in sched._buckets.values():
        for row in list(bucket.pending):
            assert row.uploaded.wait(timeout=30)


def padded(sess, pairs_):
    lefts, rights = [], []
    for p in pairs_:
        left, right = canonical(p)
        lp, rp = sess.padder_for(left.shape).pad_np(left, right)
        lefts.append(lp)
        rights.append(rp)
    return np.concatenate(lefts), np.concatenate(rights)


def leaves(state):
    out = []
    session_mod._map_carry(lambda x: out.append(x.numpy().tobytes()), state)
    return out


# -- batch rows -------------------------------------------------------------------


def test_batched_prepare_rows_are_b1_prepare_bits(bsession, pairs):
    """The batched prepare runs row by row: each row of its carry is the
    B=1 prepare's, bit for bit."""
    lb, rb = padded(bsession, pairs)
    (sb,) = bsession.invoke(bsession.get_program("prepare", 64, 64, 0, b=4), lb, rb)
    for i in range(4):
        (s1,) = bsession.invoke(bsession.get_program("prepare", 64, 64, 0),
                                lb[i:i + 1], rb[i:i + 1])
        assert leaves(take_refinement_rows(sb, [i])) == leaves(s1), i


def test_batch_rows_bitwise_independent(bsession, pairs):
    """Within one batch width a row's segment is the same bytes next to
    three distinct batchmates or next to replicas of itself; against the
    B=1 program it holds to the canary band."""
    lb, rb = padded(bsession, pairs)
    (sb,) = bsession.invoke(bsession.get_program("prepare", 64, 64, 0, b=4), lb, rb)
    seg4 = bsession.get_program("segment", 64, 64, 2, b=4)
    _, up_batch, _ = bsession.invoke(seg4, sb)
    for i in range(4):
        _, up_pad, _ = bsession.invoke(seg4, take_refinement_rows(sb, [i] * 4))
        assert up_pad[:1].tobytes() == up_batch[i:i + 1].tobytes(), f"row {i}"
        assert up_pad[1:].tobytes() == np.concatenate([up_pad[:1]] * 3).tobytes()
        (s1,) = bsession.invoke(bsession.get_program("prepare", 64, 64, 0),
                                lb[i:i + 1], rb[i:i + 1])
        _, up_solo, _ = bsession.invoke(bsession.get_program("segment", 64, 64, 2), s1)
        assert_rows_match(up_solo, up_batch[i:i + 1], f"row {i} across widths")


def test_epilogue_composes_with_advance(bsession, pairs):
    """epilogue(advance(s)) == segment(s) at a batch bucket: the scheduler's
    split of the segment is free of cost."""
    lb, rb = padded(bsession, pairs[:2])
    (state,) = bsession.invoke(bsession.get_program("prepare", 64, 64, 0, b=2), lb, rb)
    _, up_ref, _ = bsession.invoke(bsession.get_program("segment", 64, 64, 2, b=2), state)
    carry, _, dnorm = bsession.invoke(bsession.get_program("advance", 64, 64, 2, b=2), state)
    up, low = bsession.invoke(bsession.get_program("epilogue", 64, 64, 0, b=2), carry)
    assert up.tobytes() == up_ref.tobytes()
    assert low.shape == (2, 16, 16, 1)
    assert dnorm.shape == (2,) and np.isfinite(dnorm).all() and (dnorm >= 0).all()


def test_stack_take_roundtrip(bsession, pairs):
    lb, rb = padded(bsession, pairs[:2])
    prep = bsession.get_program("prepare", 64, 64, 0)
    (sa,) = bsession.invoke(prep, lb[:1], rb[:1])
    (sb,) = bsession.invoke(prep, lb[1:], rb[1:])
    stacked = stack_refinement_states([sa, sb])
    assert leaves(take_refinement_rows(stacked, [0])) == leaves(sa)
    assert leaves(take_refinement_rows(stacked, [1])) == leaves(sb)
    with pytest.raises(ValueError):
        stack_refinement_states([])


# -- batch buckets, keys, estimates, warm-up ---------------------------------------


def test_batch_bucket_resolution_and_cache_key(tiny_model, tiny_cfg, monkeypatch):
    sess = make_session(tiny_model, tiny_cfg, max_batch=6)
    assert sess.batch_buckets == (1, 2, 4, 6)
    assert sess.batch_bucket(1) == 1
    assert sess.batch_bucket(3) == 4
    assert sess.batch_bucket(6) == 6
    with pytest.raises(ValueError, match="exceeds"):
        sess.batch_bucket(7)
    # the batch is a key component of its own: b=1 and b=4 never share
    assert sess.cache_key("advance", 64, 64, 2, b=1) != sess.cache_key("advance", 64, 64, 2,
                                                                        b=4)
    monkeypatch.setenv("RAFT_BATCH_BUCKETS", "2,8")
    assert make_session(tiny_model, tiny_cfg, max_batch=8).batch_buckets == (2, 8)
    monkeypatch.setenv("RAFT_BATCH_BUCKETS", "2,x")
    with pytest.raises(ValueError, match="RAFT_BATCH_BUCKETS"):
        make_session(tiny_model, tiny_cfg, max_batch=8)
    monkeypatch.delenv("RAFT_BATCH_BUCKETS")
    with pytest.raises(ValueError, match="batch_buckets"):
        SessionConfig(max_batch=4, batch_buckets=(4, 2))
    with pytest.raises(ValueError, match="max_batch"):
        SessionConfig(max_batch=0)
    # the LRU floor: one warm shape bucket's batched programs fit
    s8 = make_session(tiny_model, tiny_cfg, max_batch=8, max_programs=4)
    assert s8._max_programs >= 4 * len(s8.batch_buckets)
    assert s8.status()["programs"]["capacity"] == s8._max_programs
    # a warm-up that cannot fit is refused, not evicted quietly
    with pytest.raises(ValueError, match="max_programs"):
        make_session(tiny_model, tiny_cfg, max_batch=2, warmup_shapes=((H, W), (96, 128)))


def test_batched_warmup_builds_every_bucket(tiny_model, tiny_cfg):
    """A batched session's warm-up builds the full program and prepare,
    prepare_warm, advance and epilogue at every batch bucket."""
    sess = make_session(tiny_model, tiny_cfg, max_batch=2, warmup_shapes=((H, W),))
    cached = set(sess.status()["programs"]["cached"])
    want = {"full@b1:64x64/it4"} | {f"{kind}@b{b}:64x64/it{it}" for b in (1, 2)
                                    for kind, it in (("prepare", 0), ("prepare_warm", 0),
                                                     ("advance", 2), ("epilogue", 0))}
    assert cached == want
    assert all(sess.has_program(k, 64, 64, it, b=b) for b in (1, 2)
               for k, it in (("prepare", 0), ("advance", 2), ("epilogue", 0)))


def test_ema_keyed_per_batch_bucket(tiny_model, tiny_cfg, pairs):
    """A cold batch-4 call (its time includes the build) neither poisons
    nor touches the batch-1 estimate."""
    clk = FakeClock()
    plan = ServeFaultPlan(slow_forwards={1: 9.0, 2: 5.0, 3: 50.0, 4: 7.0})
    sess = make_session(tiny_model, tiny_cfg, max_batch=4, plan=plan, clock=clk)
    lp, rp = padded(sess, pairs[:1])
    (state,) = sess.invoke(sess.get_program("prepare", 64, 64, 0, b=1), lp, rp)
    adv1 = sess.get_program("advance", 64, 64, 2, b=1)
    state1, _, _ = sess.invoke(adv1, state)       # warming: excluded
    sess.invoke(adv1, state1)                      # recorded: 5.0
    assert sess.estimate(adv1.key) == pytest.approx(5.0)
    state4 = take_refinement_rows(state, [0, 0, 0, 0])
    adv4 = sess.get_program("advance", 64, 64, 2, b=4)
    assert adv4.key != adv1.key
    state4b, _, _ = sess.invoke(adv4, state4)      # warming: excluded
    assert sess.estimate(adv4.key) is None
    assert sess.estimate(adv1.key) == pytest.approx(5.0)
    sess.invoke(adv4, state4b)                     # recorded: 7.0
    assert sess.estimate(adv4.key) == pytest.approx(7.0)
    assert sess.estimate(adv1.key) == pytest.approx(5.0)


# -- the scheduler ----------------------------------------------------------------


def test_scheduler_parity_including_pad_rows(bsession, pairs):
    """Three requests (a pad row at batch bucket 4): each in the canary
    band of the sequential path (across widths), and the same bytes as the
    same three rows through the session's b=4 programs by hand."""
    refs = [bsession.infer(*p).disparity for p in pairs[:3]]
    out = []
    sched = BatchScheduler(bsession, resolve=lambda req, resp: out.append(resp))
    for i, p in enumerate(pairs[:3]):
        sched.submit(make_request(p, rid=i))
    wait_uploaded(sched)
    drive(sched, out, 3)
    by_id = {r["id"]: r for r in out}
    lb, rb = padded(bsession, pairs[:3] + pairs[:1])
    (state,) = bsession.invoke(bsession.get_program("prepare", 64, 64, 0, b=4), lb, rb)
    _, up, _ = bsession.invoke(bsession.get_program("segment", 64, 64, 4, b=4), state)
    for i in range(3):
        assert by_id[i]["status"] == "ok" and by_id[i]["quality"] == "full"
        assert_rows_match(by_id[i]["disparity"], refs[i], f"request {i}")
        by_hand = -bsession.padder_for((1, H, W, 3)).unpad_np(up[i:i + 1])[0, ..., 0]
        assert by_id[i]["disparity"].tobytes() == by_hand.tobytes(), i
    st = sched.status()
    assert st["joins"] == 3 and st["exits"] == 3
    assert st["pad_waste"] > 0
    assert st["occupancy_hist"].get("3") >= 1 and st["ticks_by_bucket"].get("4") >= 1


def test_scheduler_join_exit_boundary_parity(bsession, pairs):
    """B joins after A ran a segment; A exits while B continues: both in
    the band of their sequential runs."""
    ref_a = bsession.infer(*pairs[0]).disparity
    ref_b = bsession.infer(*pairs[1]).disparity
    out = []
    sched = BatchScheduler(bsession, resolve=lambda req, resp: out.append(resp))
    before = sched.status()["ticks_by_bucket"]  # the session's registry is shared
    sched.submit(make_request(pairs[0], rid="a"))
    wait_uploaded(sched)
    assert sched.run_tick()          # A alone: segment 1 at batch 1
    assert sched.active_rows == 1
    sched.submit(make_request(pairs[1], rid="b"))
    wait_uploaded(sched)
    assert sched.run_tick()          # B joins; A+B at batch 2; A exits
    assert len(out) == 1 and out[0]["id"] == "a" and out[0]["quality"] == "full"
    drive(sched, out, 2)
    by_id = {r["id"]: r for r in out}
    assert_rows_match(by_id["a"]["disparity"], ref_a, "a")
    assert_rows_match(by_id["b"]["disparity"], ref_b, "b")
    st = sched.status()
    assert st["active"] == 0 and st["pending"] == 0
    ticks = {b: n - before.get(b, 0) for b, n in st["ticks_by_bucket"].items()}
    assert {b: n for b, n in ticks.items() if n} == {"1": 2, "2": 1}


def test_scheduler_per_row_deadline_exit(tiny_model, tiny_cfg, pairs):
    """The deadline row exits early with an honest reduced_iters label while
    its batchmate runs to full quality."""
    clk = FakeClock()
    # ordinals: 0 prepare_b2 / 1 advance_b2 (60 fake s: past A's budget)
    plan = ServeFaultPlan(slow_forwards={1: 60.0})
    sess = make_session(tiny_model, tiny_cfg, max_batch=4, plan=plan, clock=clk)
    out = []
    sched = BatchScheduler(sess, resolve=lambda req, resp: out.append(resp))
    sched.submit(make_request(pairs[0], rid="a", deadline=clk.now() + 50.0))
    sched.submit(make_request(pairs[1], rid="b"))
    wait_uploaded(sched)
    drive(sched, out, 2)
    by_id = {r["id"]: r for r in out}
    assert by_id["a"]["status"] == "ok"
    assert by_id["a"]["quality"] == "reduced_iters:2" and by_id["a"]["iters"] == 2
    assert by_id["a"]["deadline_missed"] is True
    assert by_id["b"]["quality"] == "full"
    assert np.isfinite(by_id["a"]["disparity"]).all()
    assert_rows_match(by_id["b"]["disparity"], sess.infer(*pairs[1]).disparity, "b")
    assert sess.metrics()["degraded"] == 1


def test_scheduler_deadline_estimate_stops_early(tiny_model, tiny_cfg, pairs):
    """With a recorded estimate per (program, batch bucket) a row exits
    before overrunning: reduced label, deadline_missed False."""
    clk = FakeClock()
    plan = ServeFaultPlan(slow_forwards={1: 60.0, 2: 60.0, 5: 60.0})
    sess = make_session(tiny_model, tiny_cfg, max_batch=4, plan=plan, clock=clk)
    out = []
    sched = BatchScheduler(sess, resolve=lambda req, resp: out.append(resp))
    sched.submit(make_request(pairs[0], rid="r1"))
    wait_uploaded(sched)
    drive(sched, out, 1)
    assert sess.estimate(sess.cache_key("advance", 64, 64, 2, b=1)) == pytest.approx(60.0)
    sched.submit(make_request(pairs[1], rid="r2", deadline=clk.now() + 100.0))
    wait_uploaded(sched)
    drive(sched, out, 2)
    r2 = next(r for r in out if r["id"] == "r2")
    assert r2["quality"] == "reduced_iters:2" and r2["deadline_missed"] is False


def test_scheduler_deadline_expired_in_queue(bsession, pairs):
    out = []
    sched = BatchScheduler(bsession, resolve=lambda req, resp: out.append(resp))
    sched.submit(make_request(pairs[0], rid="late", deadline=bsession.clock.now() - 1.0))
    wait_uploaded(sched)
    compiles = bsession.metrics()["compiles"]
    drive(sched, out, 1)
    assert out[0]["status"] == "rejected"
    assert out[0]["code"] == "deadline_exceeded_in_queue"
    assert bsession.metrics()["compiles"] == compiles


def test_scheduler_nonfinite_output_structured(tiny_model, tiny_cfg, pairs):
    # ordinals: 0 prepare / 1-2 advances / 3 epilogue (poisoned)
    sess = make_session(tiny_model, tiny_cfg, plan=ServeFaultPlan(poison_outputs=(3,)))
    out = []
    sched = BatchScheduler(sess, resolve=lambda req, resp: out.append(resp))
    sched.submit(make_request(pairs[0], rid="x"))
    wait_uploaded(sched)
    drive(sched, out, 1)
    assert out[0]["status"] == "error" and out[0]["code"] == "nonfinite_output"
    assert sess.metrics()["nonfinite_outputs"] == 1
    sched.submit(make_request(pairs[1], rid="y"))
    wait_uploaded(sched)
    drive(sched, out, 2)
    assert out[1]["status"] == "ok"


def _failing_advance(monkeypatch, message):
    """The next advance raises ``message`` once."""
    real = session_mod.raft_stereo_segment_carry
    fails = iter([RuntimeError(message)])

    def segment_carry(*a, **k):
        exc = next(fails, None)
        if exc is not None:
            raise exc
        return real(*a, **k)
    monkeypatch.setattr(session_mod, "raft_stereo_segment_carry", segment_carry)


def test_scheduler_plain_rung_failure_fails_every_row(tiny_model, tiny_cfg, pairs,
                                                       monkeypatch):
    """Under the card's breaker a failure whose rung would fall back to
    plain PyTorch ends every row of the tick in kernel_failed, with no trip
    and nothing stranded; the next request is served."""
    sess = make_session(tiny_model, tiny_cfg, breaker=KernelCircuitBreaker(kernels_only=True))
    _failing_advance(monkeypatch, "CUDA kernel corr_lookup failed to launch: cudaError_t 1")
    out = []
    sched = BatchScheduler(sess, resolve=lambda req, resp: out.append(resp))
    for i in range(3):
        sched.submit(make_request(pairs[i], rid=i))
    wait_uploaded(sched)
    drive(sched, out, 3)
    assert sorted(r["id"] for r in out) == [0, 1, 2]
    assert all(r["status"] == "error" and r["code"] == "kernel_failed" for r in out)
    assert sess.breaker.trip_count == 0 and sess.metrics()["requests_failed"] == 3
    assert sched.active_rows == 0 and not sched.has_work
    sched.submit(make_request(pairs[3], rid=3))
    wait_uploaded(sched)
    drive(sched, out, 4)
    assert out[3]["status"] == "ok" and out[3]["quality"] == "full"


def test_scheduler_sticky_cuda_error_fails_fast(tiny_model, tiny_cfg, pairs, monkeypatch):
    """A sticky CUDA error fails the tick's rows with cuda_sticky_error and
    every later request at once, with no retry and no trip."""
    sess = make_session(tiny_model, tiny_cfg)
    _failing_advance(monkeypatch, "CUDA error: an illegal memory access was encountered")
    out = []
    sched = BatchScheduler(sess, resolve=lambda req, resp: out.append(resp))
    for i in range(2):
        sched.submit(make_request(pairs[i], rid=i))
    wait_uploaded(sched)
    drive(sched, out, 2)
    sched.submit(make_request(pairs[2], rid=2))
    wait_uploaded(sched)
    drive(sched, out, 3)
    assert [r["code"] for r in out] == ["cuda_sticky_error"] * 3
    assert sess.breaker.trip_count == 0 and sess.status()["fatal"] == "cuda_sticky_error"


# -- the batched service ----------------------------------------------------------


def test_batched_service_end_to_end(bsession, pairs):
    refs = [bsession.infer(*p).disparity for p in pairs]
    with StereoService(bsession, ServiceConfig(max_queue=8)) as svc:
        futs = [svc.submit({"id": i, "left": p[0], "right": p[1]})
                for i, p in enumerate(pairs)]
        resps = [f.result(timeout=60) for f in futs]
    for i, r in enumerate(resps):
        assert r["status"] == "ok" and r["id"] == i and r["quality"] == "full"
        assert_rows_match(r["disparity"], refs[i], f"request {i}")
    st = svc.status()
    assert st["requests"]["ok"] == 4
    b = st["batching"]
    assert b["joins"] >= 4 and b["exits"] >= 4 and b["max_batch"] == 4
    assert b["occupancy_hist"] and b["tick_latency_ms"]["p50"] is not None
    assert st["session"]["max_batch"] == 4
    assert st["session"]["batch_buckets"] == [1, 2, 4]
    assert st["queue"]["workers"] == 1


def test_batched_service_queue_full_backpressure(tiny_model, tiny_cfg, pairs):
    """Scheduler parked mid-tick and a depth-1 queue: the third concurrent
    request is rejected queue_full at once."""
    class GateClock:
        def __init__(self):
            self.gate = threading.Event()

        @staticmethod
        def now():
            return time.monotonic()

        def sleep(self, _seconds):
            assert self.gate.wait(timeout=30)

    clk = GateClock()
    # ordinal 0 = r1's prepare, 1 = r1's first advance (gated)
    sess = make_session(tiny_model, tiny_cfg, max_batch=2, clock=clk,
                        plan=ServeFaultPlan(slow_forwards={1: 1.0}))
    svc = StereoService(sess, ServiceConfig(max_queue=1)).start()
    try:
        f1 = svc.submit({"id": 1, "left": pairs[0][0], "right": pairs[0][1]})
        for _ in range(3000):
            if sess.faults.forwards >= 2:
                break
            time.sleep(0.01)
        assert sess.faults.forwards >= 2
        f2 = svc.submit({"id": 2, "left": pairs[1][0], "right": pairs[1][1]})
        f3 = svc.submit({"id": 3, "left": pairs[2][0], "right": pairs[2][1]})
        resp3 = f3.result(timeout=5)
        clk.gate.set()
        r1, r2 = f1.result(timeout=60), f2.result(timeout=60)
    finally:
        clk.gate.set()
        svc.stop()
    assert resp3["status"] == "rejected" and resp3["code"] == "queue_full"
    assert r1["status"] == "ok" and r2["status"] == "ok"
    assert svc.status()["requests"]["rejected:queue_full"] == 1


def test_batched_service_restart_serves(bsession, pairs):
    svc = StereoService(bsession, ServiceConfig(max_queue=8))
    for generation in range(2):
        svc.start()
        r = svc.submit({"id": generation, "left": pairs[0][0],
                        "right": pairs[0][1]}).result(timeout=60)
        assert r["status"] == "ok", (generation, r)
        svc.stop()


def test_batched_service_stop_resolves_every_future(bsession, pairs):
    svc = StereoService(bsession, ServiceConfig(max_queue=8)).start()
    futs = [svc.submit({"id": i, "left": p[0], "right": p[1]}) for i, p in enumerate(pairs)]
    svc.stop()
    for f in futs:
        r = f.result(timeout=60)
        assert r["status"] in ("ok", "rejected")
        if r["status"] == "rejected":
            assert r["code"] in ("service_stopped", "not_running")


# -- parity with the JAX package's scheduler ---------------------------------------


def test_scheduler_matches_jax_scheduler(pairs):
    """The same four pairs through the JAX BatchScheduler and the port's at
    max_batch 4, fp32, over the same weights (the port's seeded weights
    with the flow head tempered, carried to the JAX package and back):
    disparities within 1e-4 px, equal labels and response keys."""
    cfg = RAFTStereoConfig(**TINY)
    seeded = init_raft_stereo(cfg, seed=3, device="cpu")
    with torch.no_grad():
        seeded.update_block.flow_head.conv2.weight.mul_(0.02)
        seeded.update_block.flow_head.conv2.bias.mul_(0.02)
    jcfg = JaxConfig(**TINY)
    params = transplant_state_dict(seeded.state_dict(), jcfg)
    model = RAFTStereo(cfg)
    load_state_dict(model, params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), cfg))
    model.eval()
    jx = JaxSession(params, jcfg, JaxSessionConfig(valid_iters=4, segments=2, max_batch=4),
                    clock=JaxFakeClock())
    pt = make_session(model, cfg, max_batch=4)
    outs = {}
    for name, sess, sched_cls in (("jax", jx, JaxScheduler), ("port", pt, BatchScheduler)):
        out = []
        sched = sched_cls(sess, resolve=lambda req, resp, out=out: out.append(resp))
        for i, p in enumerate(pairs):
            sched.submit(make_request(p, rid=i))
        wait_uploaded(sched)
        drive(sched, out, 4)
        outs[name] = {r["id"]: r for r in out}
        assert sched.status()["ticks"] == 2 and sched.status()["joins"] == 4
    for i in range(4):
        a, b = outs["jax"][i], outs["port"][i]
        assert set(a) == set(b), i
        assert (a["status"], a["quality"], a["iters"]) == (b["status"], b["quality"],
                                                          b["iters"]) == ("ok", "full", 4)
        np.testing.assert_allclose(b["disparity"], np.asarray(a["disparity"]), rtol=0,
                                   atol=1e-4, err_msg=str(i))
