"""The port's serving session (raft_stereo_tpu_torch/serve/) on the CPU.

Mirrors the JAX package's serving battery (tests/test_serve.py) with its
tiny model (TINY, pairs of 40x60, bucketed to 64x64), ``device="cpu"`` and a
``FakeClock``: on the CPU the session's programs run eagerly, each kernel
wrapper on its plain version. Every fault is injected through a
``ServeFaultPlan`` (deterministic ordinals, no real sleeping).

- Segments compose bit for bit through the session's programs, and the
  session's output equals the port's eager forward bit for bit.
- Admission control, the non-finite output error, the cache key over every
  config field and switch, the LRU bound, one build for racing first
  requests.
- The breaker: the port's ladder (the JAX ladder without stream_batch,
  packed_l2 and fused_update) walked to its bottom rung, which still runs
  the serial loop kernels' wrappers; matchers by the port's kernel names;
  exhaustion, sticky CUDA errors and capture failures as structured errors.
- The canary against the plain program; the deadline paths.
- Parity with the JAX package's ``InferenceSession`` on transplanted
  weights in fp32, with and without a deadline: within 1e-4 px (ROADMAP
  ground rules, "Tolerances": summation order only).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.faults import FakeClock as JaxFakeClock
from raft_stereo_tpu.faults import ServeFaultPlan as JaxFaultPlan
from raft_stereo_tpu.serve import InferenceSession as JaxSession
from raft_stereo_tpu.serve import SessionConfig as JaxSessionConfig
from raft_stereo_tpu.transplant.torch_loader import transplant_state_dict

import raft_stereo_tpu_torch.serve.session as session_mod
from raft_stereo_tpu_torch import (RAFTStereo, RAFTStereoConfig, init_raft_stereo,
                                   raft_stereo_forward)
from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
from raft_stereo_tpu_torch.faults import FakeClock, ServeFaultPlan, malformed_pairs
from raft_stereo_tpu_torch.ops import stream
from raft_stereo_tpu_torch.ops.padder import InputPadder
from raft_stereo_tpu_torch.serve import (DEFAULT_LADDER, DeadlineExceeded, InferenceFailed,
                                         InferenceSession, InputRejected,
                                         KernelCircuitBreaker, SessionConfig)
from raft_stereo_tpu_torch.transplant import load_state_dict, params_from_jax

pytestmark = pytest.mark.serve

TINY = dict(n_gru_layers=1, hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
H, W = 40, 60  # not multiples of 32: bucketing must pad

# The port's ladder: the JAX package's rungs whose switch the port has, in
# its order; stream_batch, packed_l2 and fused_update have no counterpart.
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
def tiny_model(tiny_cfg):
    return init_raft_stereo(tiny_cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 255, (H, W, 3)).astype(np.float32),
            rng.uniform(0, 255, (H, W, 3)).astype(np.float32))


def make_session(model, cfg, *, valid_iters=4, segments=2, plan=None, clock=None,
                 breaker=None, **kw):
    scfg = SessionConfig(valid_iters=valid_iters, segments=segments,
                         canary=kw.pop("canary", False), **kw)
    return InferenceSession(model, cfg, scfg, device="cpu", fault_plan=plan,
                            clock=clock or FakeClock(), breaker=breaker)


@pytest.fixture(scope="module")
def clean_session(tiny_model, tiny_cfg):
    """A shared fault-free session for the read-only tests; it warms its
    one bucket (full, prepare/segment and the half bucket's) at
    construction."""
    return make_session(tiny_model, tiny_cfg, warmup_shapes=((H, W),), warmup_segmented=True)


def _eager_disparity(model, left, right, iters):
    padder = InputPadder(left[None].shape, divis_by=32)
    a, b = padder.pad(torch.from_numpy(left[None]), torch.from_numpy(right[None]))
    _, flow = raft_stereo_forward(model, a, b, iters=iters)
    return -padder.unpad(flow)[0, ..., 0].numpy()


# -- programs, segments, eager equality ------------------------------------------


def test_segments_compose_bit_identical(tiny_model, tiny_cfg, pair):
    """k segment programs of m iterations from the carried state == one
    program of k*m: the invariant the deadline path stands on."""
    sess = make_session(tiny_model, tiny_cfg)
    padder = sess.padder_for(pair[0][None].shape)
    lp, rp = padder.pad_np(pair[0][None], pair[1][None])
    (state,) = sess.invoke(sess.get_program("prepare", 64, 64, 0), lp, rp)
    _, flow_a, _ = sess.invoke(sess.get_program("segment", 64, 64, 4), state)
    seg2 = sess.get_program("segment", 64, 64, 2)
    s = state
    for _ in range(2):
        s, flow_b, _ = sess.invoke(seg2, s)
    assert flow_a.tobytes() == flow_b.tobytes()
    (full, _) = sess.invoke(sess.get_program("full", 64, 64, 4), lp, rp)
    assert full.tobytes() == flow_a.tobytes()


def test_streaming_programs_compose(tiny_model, tiny_cfg, pair):
    """prepare_warm on a zero flow gives prepare's carry; advance then
    epilogue gives segment's flow, bit for bit."""
    sess = make_session(tiny_model, tiny_cfg)
    padder = sess.padder_for(pair[0][None].shape)
    lp, rp = padder.pad_np(pair[0][None], pair[1][None])
    (cold,) = sess.invoke(sess.get_program("prepare", 64, 64, 0), lp, rp)
    (warm,) = sess.invoke(sess.get_program("prepare_warm", 64, 64, 0), lp, rp,
                          np.zeros((1, 16, 16, 1), np.float32))
    assert torch.equal(cold["coords1"], warm["coords1"])
    state, rowsum, dnorm = sess.invoke(sess.get_program("advance", 64, 64, 2), cold)
    assert rowsum.shape == (1,) and dnorm.shape == (1,)
    flow_up, flow_x = sess.invoke(sess.get_program("epilogue", 64, 64, 0), state)
    _, seg_flow, _ = sess.invoke(sess.get_program("segment", 64, 64, 2), cold)
    assert flow_up.tobytes() == seg_flow.tobytes() and flow_x.shape == (1, 16, 16, 1)


def test_session_serves_full_quality(clean_session, pair):
    # warm-up built full, prepare and segment, and the half bucket's
    # prepare and segment
    warm = clean_session.metrics()["compiles"]
    assert warm == 5
    res = clean_session.infer(*pair)
    assert res.quality == "full" and not res.degraded and res.iters == 4
    assert res.disparity.shape == (H, W) and np.isfinite(res.disparity).all()
    assert res.padded_shape == (64, 64) and res.tripped == ()
    assert clean_session.metrics()["compiles"] == warm  # a warm bucket builds nothing


def test_session_matches_eager_forward_bytes(clean_session, tiny_model, pair):
    res = clean_session.infer(*pair)
    assert res.disparity.tobytes() == _eager_disparity(tiny_model, *pair, 4).tobytes()


def test_deadline_path_bit_identical_when_unconstrained(clean_session, pair):
    ref = clean_session.infer(*pair)
    res = clean_session.infer(*pair, budget_s=1e6)
    assert res.quality == "full"
    assert res.disparity.tobytes() == ref.disparity.tobytes()


def test_session_accepts_batched_and_unbatched(clean_session, pair):
    a = clean_session.infer(pair[0], pair[1])
    b = clean_session.infer(pair[0][None], pair[1][None])
    assert a.disparity.tobytes() == b.disparity.tobytes()


def test_ledger_rows_for_every_program(clean_session):
    doc = clean_session.ledger_doc()
    assert doc["complete"] and doc["rows"]
    for row in doc["rows"]:
        assert row["flops"] and row["capture_s"] is None and row["peak_hbm_bytes"] is None


def test_device_defaults_to_the_card(tiny_model, tiny_cfg):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceSession(tiny_model, tiny_cfg, SessionConfig(valid_iters=4, segments=2))


def test_unported_serving_modes_raise():
    """Every serving mode is ported: batched programs (the scheduler,
    tests/test_torch_scheduler.py) and the data mesh
    (tests/test_torch_mesh_serve.py); a batch or a mesh below one is
    refused."""
    SessionConfig(max_batch=2)
    with pytest.raises(ValueError, match="max_batch"):
        SessionConfig(max_batch=0)
    SessionConfig(mesh_data=2)
    SessionConfig(mesh_data=1)
    with pytest.raises(ValueError, match="mesh_data"):
        SessionConfig(mesh_data=0)


@pytest.mark.parametrize("segmented,half,canary,need", [
    (False, True, False, 2), (True, False, False, 6), (True, True, False, 10),
    (True, True, True, 11)])
def test_max_programs_must_hold_the_warm_up(segmented, half, canary, need):
    """Two warm-up shapes build a full program each, with warmup_segmented
    a prepare and a segment each and as many for the half buckets, and the
    canary one more: a smaller LRU bound is refused, not raised quietly."""
    kw = dict(warmup_shapes=((H, W), (96, 128)), warmup_segmented=segmented,
              allow_half_res=half, canary=canary)
    assert SessionConfig(max_programs=need, **kw).warmup_programs == need
    with pytest.raises(ValueError, match="max_programs"):
        SessionConfig(max_programs=need - 1, **kw)


def test_cfg_must_match_the_model(tiny_model):
    with pytest.raises(ValueError, match="architecture"):
        make_session(tiny_model, RAFTStereoConfig(**{**TINY, "corr_radius": 3}))


# -- admission and output validation ---------------------------------------------


def test_malformed_inputs_rejected(clean_session):
    cases = malformed_pairs(h=H, w=W, oversize_pixels=clean_session.cfg.admission.max_pixels)
    expected = {"nan_pixels": "nonfinite_input", "inf_pixels": "nonfinite_input",
                "five_channel": "bad_channels", "zero_area": "zero_area",
                "mismatched_shapes": "shape_mismatch", "wrong_rank": "wrong_rank",
                "not_an_array": "wrong_rank", "oversized": "too_large"}
    for name, (left, right) in cases.items():
        with pytest.raises(InputRejected) as ei:
            clean_session.infer(left, right)
        assert ei.value.code == expected[name], name


def test_nonfinite_output_is_structured_error(tiny_model, tiny_cfg, pair):
    sess = make_session(tiny_model, tiny_cfg, plan=ServeFaultPlan(poison_outputs=(0,)))
    with pytest.raises(InferenceFailed) as ei:
        sess.infer(*pair)
    assert ei.value.code == "nonfinite_output"
    assert sess.metrics()["nonfinite_outputs"] == 1
    assert sess.infer(*pair).quality == "full"  # the program is fine


# -- the program cache -----------------------------------------------------------

_FIELD_CHANGES = {"corr_implementation": "alt", "mixed_precision": True,
                  "slow_fast_gru": True}


@pytest.mark.parametrize("field", sorted(_FIELD_CHANGES))
def test_cache_key_covers_config_fields(tiny_model, tiny_cfg, field):
    other = RAFTStereoConfig(**{**TINY, field: _FIELD_CHANGES[field]})
    a = make_session(tiny_model, tiny_cfg).cache_key("full", 64, 64, 4)
    b = make_session(tiny_model, other).cache_key("full", 64, 64, 4)
    assert a != b


def test_fingerprint_covers_every_config_field(tiny_cfg):
    """The fingerprint is over all config fields, not a hand-picked
    subset: a new field keys conservatively."""
    import dataclasses
    fp = session_mod.config_fingerprint(tiny_cfg, {})
    assert {name for name, _ in fp[0]} == {f.name for f in dataclasses.fields(tiny_cfg)}


@pytest.mark.parametrize("knob", ENV_KNOBS)
def test_cache_key_covers_every_switch(tiny_model, tiny_cfg, monkeypatch, knob):
    """A switch is snapshotted at construction: a session built under the
    flipped switch keys differently; an existing session's keys stay."""
    s_base = make_session(tiny_model, tiny_cfg)
    k_base = s_base.cache_key("full", 64, 64, 4)
    monkeypatch.setenv(knob, "0" if knob not in ("RAFT_CORR_PACK8", "RAFT_LANE_PACK8")
                       else "1")
    assert make_session(tiny_model, tiny_cfg).cache_key("full", 64, 64, 4) != k_base
    assert s_base.cache_key("full", 64, 64, 4) == k_base


def test_cache_key_covers_iterations(clean_session):
    assert clean_session.cache_key("segment", 64, 64, 2) != \
        clean_session.cache_key("segment", 64, 64, 4)


def test_breaker_trip_rekeys_cache(tiny_model, tiny_cfg, pair):
    """An effective trip makes the old program unreachable; a projection
    no-op (corr_kernel on a plain correlation) keys the same program."""
    sess = make_session(tiny_model, tiny_cfg)
    sess.infer(*pair)
    before = sess.metrics()["compiles"]
    key = sess.cache_key("full", 64, 64, 4)
    sess.breaker.trip("corr_kernel", "manual")  # reg -> reg
    sess._rebuild("test")
    assert sess.cache_key("full", 64, 64, 4) == key
    sess.breaker.trip("fuse_gru1632", "manual")  # a switch: effective
    sess._rebuild("test")
    assert sess.cache_key("full", 64, 64, 4) != key
    sess.infer(*pair)
    assert sess.metrics()["compiles"] == before + 1


def test_lru_bound_evicts(tiny_model, tiny_cfg):
    rng = np.random.default_rng(1)
    sess = make_session(tiny_model, tiny_cfg, max_programs=2)
    for (h, w) in ((32, 32), (32, 64), (64, 32)):
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        sess.infer(img, img)
    m = sess.metrics()
    assert m["compiles"] == 3 and m["evictions"] == 1
    assert len(sess._cache) == 2 and len(sess.ledger) == 2


def test_concurrent_first_requests_build_once(tiny_model, tiny_cfg, pair):
    sess = make_session(tiny_model, tiny_cfg, plan=ServeFaultPlan(slow_builds={0: 0.3}))
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(sess.infer, *pair) for _ in range(2)]
        results = [f.result(timeout=120) for f in futs]
    assert sess.metrics()["compiles"] == 1
    assert results[0].disparity.tobytes() == results[1].disparity.tobytes()


def test_capture_gate_runs_a_capture_alone():
    """The card's gate (serve/session.py): a capture waits for the replays
    under way, and replays that come while it waits go after it."""
    import threading
    import time
    gate = session_mod._CaptureGate()
    log, held, release = [], threading.Event(), threading.Event()

    def replay(name, hold=False):
        with gate.shared():
            log.append(name)
            if hold:
                held.set()
                release.wait(10)

    def capture():
        with gate.alone():
            log.append("capture")

    first = threading.Thread(target=replay, args=("replay 1", True))
    first.start()
    held.wait(10)
    cap = threading.Thread(target=capture)
    cap.start()
    while gate._waiting == 0:
        time.sleep(0.001)
    second = threading.Thread(target=replay, args=("replay 2",))
    second.start()
    time.sleep(0.05)
    assert log == ["replay 1"]
    release.set()
    for t in (first, cap, second):
        t.join(10)
    assert log == ["replay 1", "capture", "replay 2"]


# -- the breaker ------------------------------------------------------------------


def test_port_ladder_is_pinned():
    """The port keeps the JAX rungs whose switch it has, in the JAX order,
    and drops stream_batch (a TPU batch policy: the port's loop kernels
    engage at every batch, and its fallback would be plain PyTorch) and
    packed_l2 (a TPU layout). Its bottom rung is the JAX package's,
    fused_update, a config field of both."""
    from raft_stereo_tpu.serve.guard import DEFAULT_LADDER as JAX_LADDER
    jax_names = [p.name for p in JAX_LADDER]
    assert tuple(p.name for p in DEFAULT_LADDER) == LADDER_NAMES
    assert [n for n in jax_names if n in LADDER_NAMES] == list(LADDER_NAMES)
    assert set(jax_names) - set(LADDER_NAMES) == {"stream_batch", "packed_l2"}
    assert jax_names[-1] == LADDER_NAMES[-1] == "fused_update"
    bottom = DEFAULT_LADDER[-1]
    assert (bottom.cfg_field, bottom.cfg_fallback) == ("fused_update", False)
    for p in DEFAULT_LADDER:
        assert p.env_var is None or p.env_var in ENV_KNOBS


def test_breaker_walks_ladder_to_bottom_rung(tiny_model, pair):
    """Unattributable build failures trip every rung in order; the bottom
    rung serves the request that caused the walk, every trip loud."""
    cfg = RAFTStereoConfig(**{**TINY, "corr_implementation": "reg_cuda"})
    plan = ServeFaultPlan(compile_errors={
        i: ("mosaic" if i == 3 else "oom") for i in range(len(LADDER_NAMES))})
    sess = make_session(tiny_model, cfg, plan=plan)
    res = sess.infer(*pair)
    assert res.quality == "full" and res.tripped == LADDER_NAMES
    assert sess.breaker.tripped_names == LADDER_NAMES and sess.breaker.exhausted
    assert sess._run_cfg.corr_implementation == "reg"
    assert sess._run_cfg.fused_update is False
    assert sess._env == {k: "0" for k in ("RAFT_FUSE_ITER", "RAFT_LANE_PACK8",
                                          "RAFT_CORR_PACK8", "RAFT_FUSE_GRU1632",
                                          "RAFT_STREAM_TAIL", "RAFT_FUSED_ENCODERS")}
    st = sess.status()
    assert st["breaker"]["trip_count"] == len(LADDER_NAMES)
    assert all(r["reason"] == "compile_failure" for r in st["breaker"]["tripped"].values())
    assert sess.metrics()["trips"] == len(LADDER_NAMES)
    assert sess.metrics()["rebuilds"] == len(LADDER_NAMES)


def test_bottom_rung_still_runs_the_serial_loop_kernels(tiny_model, pair, monkeypatch):
    """Down to the rung above the bottom the bf16 loop goes through the
    serial loop kernels' wrappers (conv_gru.cu, motion.cu on the card);
    the bottom rung, fused_update, runs the torch loop and calls neither,
    as the JAX package's last ladder program runs no kernel."""
    calls = {"conv_gru": 0, "motion": 0}
    for name, fn in (("conv_gru", stream.fused_conv_gru), ("motion", stream.fused_motion)):
        def counting(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(stream, f"fused_{name}", counting)
    cfg = RAFTStereoConfig(**{**TINY, "corr_implementation": "reg_cuda",
                              "mixed_precision": True})
    sess = make_session(tiny_model, cfg)
    for name in LADDER_NAMES[:-1]:
        sess.breaker.trip(name, "manual")
    sess._rebuild("test")
    res = sess.infer(*pair)
    assert res.quality == "full" and np.isfinite(res.disparity).all()
    assert calls["conv_gru"] == 4 and calls["motion"] == 4
    sess.breaker.trip("fused_update", "manual")
    sess._rebuild("test")
    res = sess.infer(*pair)
    assert res.quality == "full" and np.isfinite(res.disparity).all()
    assert calls["conv_gru"] == 4 and calls["motion"] == 4


def test_fused_update_trip_turns_the_loop_kernels_off(tiny_model):
    """The bottom rung rewrites the config's ``fused_update`` (the JAX
    package's field and default), and a config without it takes the loop
    off the kernels in test mode and in training alike."""
    cfg = RAFTStereoConfig(**{**TINY, "mixed_precision": True, "fused_train": True})
    assert cfg.fused_update and cfg.loop_kernels(test_mode=True)
    assert cfg.loop_kernels(test_mode=False)
    breaker = KernelCircuitBreaker()
    breaker.trip("fused_update", "manual")
    run_cfg, env = breaker.apply(cfg)
    assert run_cfg.fused_update is False and env == {}
    assert not run_cfg.loop_kernels(test_mode=True)
    assert not run_cfg.loop_kernels(test_mode=False)
    assert dataclasses.replace(run_cfg, fused_update=True) == cfg
    # A session may serve a model under either value: the field moves no weight.
    make_session(tiny_model, dataclasses.replace(tiny_model.cfg, fused_update=False))


@pytest.mark.parametrize("msg,rung", [
    ("CUDA kernel resident failed to launch: cudaError_t 1", "fuse_iter"),
    ("CUDA kernel gru1632 failed to launch: cudaError_t 1", "fuse_gru1632"),
    ("CUDA kernel corr_lookup failed to launch: cudaError_t 1", "corr_kernel"),
    ("CUDA kernel corr_alt failed to launch: cudaError_t 1", "corr_kernel"),
    ("CUDA kernel enc_stem failed to launch: cudaError_t 1", "fused_encoders"),
    ("CUDA kernel enc_pass failed to launch: cudaError_t 1", "fused_encoders"),
    ("CUDA kernel enc_point failed to launch: cudaError_t 1", "fused_encoders"),
    ("injected [lane_pack8]", "lane_pack8"),
    ("injected [corr_pack8]", "corr_pack8"),
    ("injected [stream_tail]", "stream_tail"),
    # the serial loop kernels: the bottom rung, named by its matchers
    ("CUDA kernel conv_gru failed to launch: cudaError_t 1", "fused_update"),
    ("CUDA kernel motion failed to launch: cudaError_t 1", "fused_update"),
])
def test_matcher_targets_rung_by_port_names(msg, rung):
    assert KernelCircuitBreaker().classify(RuntimeError(msg)).name == rung


def test_breaker_matcher_targets_rung(tiny_model, tiny_cfg, pair):
    plan = ServeFaultPlan(compile_errors={0: "mosaic:stream_tail"})
    sess = make_session(tiny_model, tiny_cfg, plan=plan)
    sess.infer(*pair)
    assert sess.breaker.tripped_names == ("stream_tail",)


def test_launch_failure_walks_to_its_rung(tiny_model, tiny_cfg, pair, monkeypatch):
    """A wrapper's launch failure in the program's run trips the rung its
    kernel's name matches; the request is served one rung down."""
    real = session_mod.raft_stereo_forward
    fails = iter([RuntimeError("CUDA kernel gru1632 failed to launch: cudaError_t 1")])

    def forward(*a, **k):
        exc = next(fails, None)
        if exc is not None:
            raise exc
        return real(*a, **k)
    monkeypatch.setattr(session_mod, "raft_stereo_forward", forward)
    sess = make_session(tiny_model, tiny_cfg)
    res = sess.infer(*pair)
    assert res.tripped == ("fuse_gru1632",) and res.quality == "full"
    assert sess.breaker.status()["tripped"]["fuse_gru1632"]["reason"] == "runtime_failure"


def test_unclassified_kernel_failure_falls_to_next_in_order():
    breaker = KernelCircuitBreaker()
    generic = RuntimeError("kernel build failed: nvcc exit 1")
    walked = []
    for _ in LADDER_NAMES:
        path = breaker.classify(generic)
        walked.append(path.name)
        breaker.trip(path.name, "runtime_failure", generic)
    assert tuple(walked) == LADDER_NAMES
    assert breaker.classify(generic) is None and breaker.exhausted


# The card's breaker (kernels_only): the rungs whose fallback is plain
# PyTorch are never tripped there.
PLAIN_RUNGS = ("stream_tail", "corr_kernel", "fused_encoders", "fused_update")
KERNEL_RUNGS = tuple(n for n in LADDER_NAMES if n not in PLAIN_RUNGS)


def test_plain_route_rungs_are_pinned():
    assert tuple(p.name for p in DEFAULT_LADDER if p.plain_route) == PLAIN_RUNGS
    breaker = KernelCircuitBreaker(kernels_only=True)
    assert breaker.status()["kernels_only"] and not KernelCircuitBreaker().kernels_only
    for name in PLAIN_RUNGS:
        with pytest.raises(ValueError, match="plain PyTorch"):
            breaker.trip(name, "manual")
    assert breaker.trip_count == 0


@pytest.mark.parametrize("kernel", ["corr_lookup", "corr_alt", "enc_stem", "enc_pass",
                                    "enc_point"])
def test_card_breaker_ends_a_plain_rung_failure(tiny_model, tiny_cfg, pair, monkeypatch,
                                                kernel):
    """A launch failure whose rung would fall back to plain PyTorch ends in a
    structured error with no trip; the next request is served on the
    kernels' route."""
    real = session_mod.raft_stereo_forward
    fails = iter([RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError_t 1")])

    def forward(*a, **k):
        exc = next(fails, None)
        if exc is not None:
            raise exc
        return real(*a, **k)
    monkeypatch.setattr(session_mod, "raft_stereo_forward", forward)
    sess = make_session(tiny_model, tiny_cfg, breaker=KernelCircuitBreaker(kernels_only=True))
    with pytest.raises(InferenceFailed) as ei:
        sess.infer(*pair)
    assert ei.value.code == "kernel_failed" and kernel in str(ei.value)
    assert sess.breaker.trip_count == 0 and sess.metrics()["requests_failed"] == 1
    res = sess.infer(*pair)
    assert res.quality == "full" and res.tripped == ()


def test_card_breaker_walks_only_the_kernel_rungs(tiny_model, tiny_cfg, pair):
    """Unattributed OOMs walk the rungs that keep the hand-written kernels,
    in ladder order; the next one, whose rung is stream_tail, ends in
    kernel_failed, and the session stays on the kernels' route."""
    plan = ServeFaultPlan(compile_errors={i: "oom" for i in range(len(KERNEL_RUNGS) + 1)})
    sess = make_session(tiny_model, tiny_cfg, plan=plan,
                        breaker=KernelCircuitBreaker(kernels_only=True))
    with pytest.raises(InferenceFailed) as ei:
        sess.infer(*pair)
    assert ei.value.code == "kernel_failed" and "stream_tail" in str(ei.value)
    assert sess.breaker.tripped_names == KERNEL_RUNGS and sess.breaker.exhausted
    assert sess.status()["breaker"]["exhausted"]
    assert sess._run_cfg.corr_implementation == tiny_cfg.corr_implementation
    assert not any(k in sess._env for k in ("RAFT_STREAM_TAIL", "RAFT_FUSED_ENCODERS"))
    assert sess.infer(*pair).quality == "full"  # the injector's budget is spent


def test_card_canary_mismatch_stops_above_the_plain_rungs(tiny_model, tiny_cfg):
    """A canary that never agrees trips the kernel rungs one by one, then
    fails as canary_failed where the next rung would leave the kernels."""
    plan = ServeFaultPlan(poison_outputs=tuple(range(len(LADDER_NAMES) + 1)))
    with pytest.raises(InferenceFailed) as ei:
        make_session(tiny_model, tiny_cfg, plan=plan, canary=True, canary_shape=(32, 48),
                     canary_iters=2, breaker=KernelCircuitBreaker(kernels_only=True))
    assert ei.value.code == "canary_failed" and "stream_tail" in str(ei.value)


def test_breaker_exhaustion_is_structured(tiny_model, tiny_cfg, pair):
    plan = ServeFaultPlan(compile_errors={i: "oom" for i in range(len(LADDER_NAMES) + 1)})
    sess = make_session(tiny_model, tiny_cfg, plan=plan)
    with pytest.raises(InferenceFailed) as ei:
        sess.infer(*pair)
    assert ei.value.code == "ladder_exhausted"
    assert sess.infer(*pair).quality == "full"  # the injector's budget is spent


def test_sticky_cuda_error_is_structured_without_retry(tiny_model, tiny_cfg, pair,
                                                       monkeypatch):
    def forward(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")
    monkeypatch.setattr(session_mod, "raft_stereo_forward", forward)
    sess = make_session(tiny_model, tiny_cfg)
    with pytest.raises(InferenceFailed) as ei:
        sess.infer(*pair)
    assert ei.value.code == "cuda_sticky_error"
    assert sess.breaker.trip_count == 0
    monkeypatch.undo()
    with pytest.raises(InferenceFailed) as ei:  # the context is gone: fail fast
        sess.infer(*pair)
    assert ei.value.code == "cuda_sticky_error"
    assert sess.status()["fatal"] == "cuda_sticky_error"


def test_capture_failure_is_structured_without_retry(tiny_model, tiny_cfg, pair,
                                                     monkeypatch):
    sess = make_session(tiny_model, tiny_cfg)

    def run(prog, args):
        exc = RuntimeError("operation not permitted when stream is capturing")
        exc._raft_phase = "capture_failure"
        raise exc
    monkeypatch.setattr(sess, "_run", run)
    with pytest.raises(InferenceFailed) as ei:
        sess.infer(*pair)
    assert ei.value.code == "capture_failed"
    assert sess.breaker.trip_count == 0


def test_non_kernel_errors_propagate(tiny_model, tiny_cfg, pair, monkeypatch):
    def forward(*a, **k):
        raise TypeError("a bug of our own")
    monkeypatch.setattr(session_mod, "raft_stereo_forward", forward)
    sess = make_session(tiny_model, tiny_cfg)
    with pytest.raises(TypeError):
        sess.infer(*pair)
    assert sess.breaker.trip_count == 0


# -- the canary -------------------------------------------------------------------


def test_canary_catches_corrupted_output(tiny_model, tiny_cfg):
    """A poisoned fast-path forward trips a rung (the first in ladder
    order, the mismatch naming none) and the rebuilt session serves."""
    sess = make_session(tiny_model, tiny_cfg, plan=ServeFaultPlan(poison_outputs=(0,)),
                        canary=True, canary_shape=(32, 48), canary_iters=2)
    assert sess._canary_state == {"enabled": True, "ran": True, "passed": True,
                                  "attempts": 2}
    assert sess.breaker.tripped_names == ("fuse_iter",)
    assert sess.breaker.status()["tripped"]["fuse_iter"]["reason"] == "canary_mismatch"


def test_canary_clean_pass_no_trips(tiny_model, tiny_cfg):
    sess = make_session(tiny_model, tiny_cfg, canary=True, canary_shape=(32, 48),
                        canary_iters=2)
    assert sess._canary_state["passed"] is True and sess.breaker.trip_count == 0


def test_heal_reengages_a_rung_after_a_passing_canary(tiny_model, tiny_cfg):
    clk = FakeClock()
    sess = make_session(tiny_model, tiny_cfg, clock=clk, canary_shape=(32, 48),
                        canary_iters=2)
    sess._trip("fuse_gru1632", "manual")
    sess._rebuild("test")
    assert sess.heal_breaker() is None  # still in its backoff
    clk.sleep(31.0)
    out = sess.heal_breaker()
    assert out == {"rung": "fuse_gru1632", "passed": True}
    assert sess.breaker.tripped_names == ()


# -- deadlines --------------------------------------------------------------------


def test_deadline_reduced_iters(tiny_model, tiny_cfg, pair):
    """The budget expires mid-loop: best-so-far with an honest label."""
    # ordinal 0 = prepare, 1 = the first segment (50 fake seconds)
    sess = make_session(tiny_model, tiny_cfg, plan=ServeFaultPlan(slow_forwards={1: 50.0}))
    res = sess.infer(*pair, budget_s=10.0)
    assert res.quality == "reduced_iters:2" and res.iters == 2
    assert res.deadline_missed and np.isfinite(res.disparity).all()
    assert sess.metrics()["degraded"] == 1


def test_deadline_stops_before_overrunning_segment(tiny_model, tiny_cfg, pair):
    sess = make_session(tiny_model, tiny_cfg,
                        plan=ServeFaultPlan(slow_forwards={1: 30.0, 2: 30.0, 4: 30.0}))
    sess.infer(*pair, budget_s=1000.0)      # seeds the segment estimate
    res = sess.infer(*pair, budget_s=45.0)  # fits one segment, not two
    assert res.quality == "reduced_iters:2" and not res.deadline_missed


def test_deadline_half_res(tiny_model, tiny_cfg, pair):
    """When the estimates prove one full-resolution segment cannot fit and
    the half bucket is warm, the pair runs at half resolution."""
    # Warm-up: ordinals 0-4 (full, prepare, segment, half prepare, half
    # segment; first calls record no estimate). The seeding request's
    # prepare and segments, 5-7, take 40 fake seconds each.
    sess = make_session(tiny_model, tiny_cfg, warmup_shapes=((H, W),), warmup_segmented=True,
                        plan=ServeFaultPlan(slow_forwards={5: 40.0, 6: 40.0, 7: 40.0}))
    assert sess.infer(*pair, budget_s=1e6).quality == "full"
    res = sess.infer(*pair, budget_s=20.0)
    assert res.quality == "half_res" and res.degraded
    assert res.disparity.shape == (H, W) and np.isfinite(res.disparity).all()
    res2 = sess.infer(*pair, budget_s=20.0, allow_half_res=False)
    assert res2.quality.startswith("reduced_iters:")
    # a cold half bucket is never routed to
    cold = make_session(tiny_model, tiny_cfg, plan=ServeFaultPlan(
        slow_forwards={2: 40.0, 3: 40.0, 4: 40.0, 5: 40.0}))
    cold.infer(*pair, budget_s=1e6)
    cold.infer(*pair, budget_s=1e6)
    assert cold.infer(*pair, budget_s=20.0).quality.startswith("reduced_iters:")


def test_deadline_already_expired(clean_session, pair):
    with pytest.raises(DeadlineExceeded):
        clean_session.infer(*pair, budget_s=-1.0)


def test_clean_path_zero_trips(clean_session, pair):
    clean_session.infer(*pair)
    assert clean_session.breaker.trip_count == 0
    assert clean_session.metrics()["rebuilds"] == 0


# -- parity with the JAX package's session ----------------------------------------


@pytest.fixture(scope="module")
def jax_pair():
    """One JAX session and one port session over the same weights (fp32,
    ``reg``): the port's seeded weights with the flow head tempered (see
    test_torch_model.py), carried to the JAX package
    (``transplant_state_dict``, cheaper than its init) and back
    (``params_from_jax``), each session with the deadline request's first
    segment slowed by an injected 50 fake seconds."""
    cfg = RAFTStereoConfig(**TINY)
    seeded = init_raft_stereo(cfg, seed=3, device="cpu")
    with torch.no_grad():
        seeded.update_block.flow_head.conv2.weight.mul_(0.02)
        seeded.update_block.flow_head.conv2.bias.mul_(0.02)
    jcfg = JaxConfig(**TINY)
    params = transplant_state_dict(seeded.state_dict(), jcfg)
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    model = RAFTStereo(cfg)
    load_state_dict(model, params_from_jax(np_params, cfg))
    model.eval()
    # ordinal 0: the full request; 1: the deadline request's prepare, 2 its
    # first segment (50 fake seconds, past a 10 s budget)
    jx = JaxSession(params, jcfg, JaxSessionConfig(valid_iters=4, segments=2),
                    fault_plan=JaxFaultPlan(slow_forwards={2: 50.0}), clock=JaxFakeClock())
    pt = make_session(model, RAFTStereoConfig(**TINY),
                      plan=ServeFaultPlan(slow_forwards={2: 50.0}))
    return jx, pt


def test_session_matches_jax_session(jax_pair, pair):
    """The same pair through both sessions: a full request, a deadline
    request cut after one segment (reduced_iters:2), and a deadline that
    fits every segment."""
    jx, pt = jax_pair
    for kw, quality in (({}, "full"), ({"budget_s": 10.0}, "reduced_iters:2"),
                        ({"budget_s": 1e6}, "full")):
        a, b = jx.infer(*pair, **kw), pt.infer(*pair, **kw)
        assert a.quality == b.quality == quality, kw
        assert a.padded_shape == b.padded_shape and a.deadline_missed == b.deadline_missed
        np.testing.assert_allclose(b.disparity, a.disparity, rtol=0, atol=1e-4, err_msg=kw)
