"""The port's response cache (serve/cache.py) on the CPU.

Mirrors every case of the JAX package's cache battery (tests/test_cache.py)
with its tiny model (TINY, pairs of 40x60 bucketed to 64x64),
``device="cpu"`` and a ``FakeClock``: exact hits bit for bit and with zero
device seconds, fingerprint-change invalidation, tenant isolation and
own-LRU sub-caps, TTL expiry, byte-cap accounting, the near tier
(tolerance 0 fully off; ``warm:cache:k`` labels with honest iteration
counts), the churn-storm bound, drain, the stream interplay, and the
``RAFT_CACHE_DIR`` disk spill (its unique temporary names, torn and corrupt
files as misses). ``block_signature`` and ``signature_distance`` are held
bit for bit to the JAX package's on the same padded images, and the knob
resolvers give the JAX resolvers' answers and errors.

The cache is off by library default, so every service here arms it.
"""

import os

import numpy as np
import pytest
import torch

from raft_stereo_tpu.serve import cache as jax_cache

import raft_stereo_tpu_torch.serve.cache as pt_cache
from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo
from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
from raft_stereo_tpu_torch.faults import FakeClock, ServeFaultPlan
from raft_stereo_tpu_torch.serve import (InferenceSession, ResponseCache, ServiceConfig,
                                         SessionConfig, StereoService)
from raft_stereo_tpu_torch.serve.cache import block_signature, signature_distance

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
    for knob in ENV_KNOBS + ("RAFT_BATCH_BUCKETS", "RAFT_CACHE_BYTES", "RAFT_CACHE_TTL_MS",
                             "RAFT_CACHE_NEAR_TOL", "RAFT_CACHE_DIR", "RAFT_CONVERGE_TOL"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def tiny_cfg():
    return RAFTStereoConfig(**TINY)


@pytest.fixture(scope="module")
def tiny_params(tiny_cfg):
    """The port's model (the JAX battery's fixture name kept)."""
    return init_raft_stereo(tiny_cfg, seed=0, device="cpu")


def make_pair(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32),
            rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32))


def perturb(img, seed=1, sigma=2.0):
    rng = np.random.default_rng(seed)
    return np.clip(img + rng.normal(0, sigma, img.shape),
                   0, 255).astype(np.float32)


def make_service(params, cfg, *, clock=None, plan=None, max_batch=1,
                 cache_bytes=64 << 20, **svc_kw):
    session = InferenceSession(
        params, cfg,
        SessionConfig(valid_iters=4, segments=2, max_batch=max_batch,
                      canary=False,
                      batch_buckets=(1, max_batch) if max_batch > 1
                      else ()),
        device="cpu", clock=clock or FakeClock(), fault_plan=plan)
    return StereoService(session, ServiceConfig(
        max_queue=16, cache_bytes=cache_bytes, **svc_kw))


def request(left, right, rid=None, tenant=None, **kw):
    req = {"id": rid, "left": left.copy(), "right": right.copy()}
    if tenant is not None:
        req["tenant"] = tenant
    req.update(kw)
    return req


# ---------------------------------------------------------------------------
# Knob resolution: named errors, defaults, library-off default.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [pt_cache, jax_cache], ids=["port", "jax"])
def test_knob_resolution_named_errors(monkeypatch, mod):
    """The same answers and named errors from both packages' resolvers."""
    resolve_cache_bytes = mod.resolve_cache_bytes
    resolve_cache_ttl_ms = mod.resolve_cache_ttl_ms
    resolve_cache_near_tol = mod.resolve_cache_near_tol
    resolve_cache_dir = mod.resolve_cache_dir
    monkeypatch.delenv("RAFT_CACHE_BYTES", raising=False)
    assert resolve_cache_bytes() == 0  # library default: disabled
    assert resolve_cache_bytes(123) == 123
    monkeypatch.setenv("RAFT_CACHE_BYTES", "1024")
    assert resolve_cache_bytes() == 1024
    monkeypatch.setenv("RAFT_CACHE_BYTES", "-1")
    with pytest.raises(ValueError, match="RAFT_CACHE_BYTES"):
        resolve_cache_bytes()
    monkeypatch.setenv("RAFT_CACHE_BYTES", "zonk")
    with pytest.raises(ValueError, match="RAFT_CACHE_BYTES"):
        resolve_cache_bytes()
    monkeypatch.setenv("RAFT_CACHE_TTL_MS", "0")
    with pytest.raises(ValueError, match="RAFT_CACHE_TTL_MS"):
        resolve_cache_ttl_ms()
    monkeypatch.delenv("RAFT_CACHE_TTL_MS", raising=False)
    assert resolve_cache_ttl_ms() == pytest.approx(600_000.0)
    monkeypatch.setenv("RAFT_CACHE_NEAR_TOL", "-0.5")
    with pytest.raises(ValueError, match="RAFT_CACHE_NEAR_TOL"):
        resolve_cache_near_tol()
    monkeypatch.delenv("RAFT_CACHE_NEAR_TOL", raising=False)
    assert resolve_cache_near_tol() == 0.0
    monkeypatch.delenv("RAFT_CACHE_DIR", raising=False)
    assert resolve_cache_dir() is None
    monkeypatch.setenv("RAFT_CACHE_DIR", "/tmp/x")
    assert resolve_cache_dir() == "/tmp/x"


def test_disabled_cache_is_inert(tiny_params, tiny_cfg):
    """cache_bytes=0 (the ServiceConfig default): no key stamping, no
    counters, identical serving behavior."""
    svc = make_service(tiny_params, tiny_cfg, cache_bytes=0)
    la, ra = make_pair(0)
    req = request(la, ra, rid="x")
    r1 = svc.handle(req)
    r2 = svc.handle(request(la, ra, rid="y"))
    assert r1["quality"] == "full" and r2["quality"] == "full"
    assert "_cache_key" not in req
    assert not svc.cache.enabled
    assert int(svc.registry.value("raft_cache_misses_total")) == 0


# ---------------------------------------------------------------------------
# Exact tier: bitwise parity, zero device seconds, invalidation,
# isolation.
# ---------------------------------------------------------------------------


def test_exact_hit_bitwise_and_zero_device_seconds(tiny_params, tiny_cfg):
    """The two acceptance pins in one deterministic run: an exact hit is
    byte-identical to the cold-computed response AND moves NO device
    second anywhere — program counters, per-tenant usage nanoseconds and
    the tick deck all read exactly what they read before the hit.
    Non-vacuous: injected slow forwards make every steady compute
    provably move them."""
    clock = FakeClock()
    plan = ServeFaultPlan(slow_forwards={i: 0.5 for i in range(64)})
    svc = make_service(tiny_params, tiny_cfg, clock=clock, plan=plan)
    la, ra = make_pair(0)
    lb, rb = make_pair(1)
    svc.handle(request(lb, rb, rid="warmup"))       # pays the compile
    cold = svc.handle(request(la, ra, rid="cold"))  # steady compute
    assert cold["status"] == "ok" and cold["quality"] == "full"
    reg = svc.registry

    def dev_total():
        return sum(v for _, v in
                   reg.series("raft_program_device_seconds_total"))

    dev0 = dev_total()
    usage0 = svc.session.usage.device_ns_total
    deck0 = len(svc.session.deck.snapshot())
    assert dev0 > 0  # the steady compute moved the counter: non-vacuous

    hit = svc.handle(request(la, ra, rid="hit"))
    assert hit["status"] == "ok"
    assert hit["quality"] == "cache:exact"
    assert hit["iters"] == cold["iters"]
    assert hit["disparity"].tobytes() == cold["disparity"].tobytes()
    assert dev_total() == dev0
    assert svc.session.usage.device_ns_total == usage0
    assert len(svc.session.deck.snapshot()) == deck0
    assert int(reg.value("raft_cache_hits_total")) == 1
    # the served hit array is a COPY: mutating it cannot poison the store
    hit["disparity"][0, 0] = 1e6
    hit2 = svc.handle(request(la, ra, rid="hit2"))
    assert hit2["disparity"].tobytes() == cold["disparity"].tobytes()
    # outcome accounting: hits count ok (+degraded under the
    # label-not-full convention), and the per-tenant usage rollup
    # carries the cache columns
    counts = {labels["outcome"]: int(v) for labels, v in
              reg.series("raft_requests_total")}
    assert counts["ok"] == 4
    assert counts["degraded"] == 2  # the two cache:exact labels
    doc = svc.session.usage.doc()
    assert doc["by_tenant"]["default"]["cache"]["hits"] == 2
    assert doc["by_tenant"]["default"]["cache"]["misses"] == 2


def test_fingerprint_change_invalidates(tiny_params, tiny_cfg):
    """The staleness contract: an effective breaker trip changes the
    session fingerprint, and every previously-deposited entry becomes
    structurally unreachable — the same bytes MISS and recompute."""
    svc = make_service(tiny_params, tiny_cfg)
    sess = svc.session
    la, ra = make_pair(0)
    svc.handle(request(la, ra, rid="cold"))
    assert svc.handle(request(la, ra))["quality"] == "cache:exact"
    fp_before = sess.fingerprint_id()
    # fused_encoders projects into an env switch -> the fingerprint
    # moves even though the tiny CPU program bytes may not.
    sess.breaker.trip("fused_encoders", "test")
    sess._rebuild("test trip")
    assert sess.fingerprint_id() != fp_before
    hits_before = int(svc.registry.value("raft_cache_hits_total"))
    r = svc.handle(request(la, ra, rid="after-trip"))
    assert r["quality"] == "full"  # recomputed, never served stale
    assert int(svc.registry.value("raft_cache_hits_total")) == hits_before


def test_tenant_isolation(tiny_params, tiny_cfg):
    """Tenant A's scene is never served to tenant B, even for
    bit-identical uploads — the tenant is part of the key, so the miss
    is structural, not probabilistic."""
    svc = make_service(tiny_params, tiny_cfg)
    la, ra = make_pair(0)
    ra1 = svc.handle(request(la, ra, tenant="alice"))
    assert svc.handle(request(la, ra, tenant="alice"))["quality"] == \
        "cache:exact"
    rb1 = svc.handle(request(la, ra, tenant="bob"))
    assert rb1["quality"] == "full"  # bob's first sight: computed
    # determinism means the bytes agree — but bob's came off the device
    assert rb1["disparity"].tobytes() == ra1["disparity"].tobytes()
    doc = svc.session.usage.doc()
    assert doc["by_tenant"]["alice"]["cache"]["hits"] == 1
    assert doc["by_tenant"]["bob"]["cache"]["hits"] == 0


def test_tenant_subcap_evicts_own_lru(tiny_params, tiny_cfg):
    """A tenant at its sub-cap evicts its OWN least-recently-used entry,
    never another tenant's (pinned: bob's entry survives alice's
    churn)."""
    svc = make_service(tiny_params, tiny_cfg)
    cache = svc.cache
    # Entry ~ disparity(9600) + flow + sig + overhead; sub-cap sized to
    # hold exactly one such entry per tenant.
    cache.per_tenant = 16_000
    a1, ra1 = make_pair(10)
    a2, ra2 = make_pair(11)
    b1, rb1 = make_pair(12)
    svc.handle(request(b1, rb1, tenant="bob"))
    svc.handle(request(a1, ra1, tenant="alice"))
    svc.handle(request(a2, ra2, tenant="alice"))  # evicts alice's first
    assert int(svc.registry.value("raft_cache_evictions_total")) == 1
    assert svc.handle(request(b1, rb1, tenant="bob"))["quality"] == \
        "cache:exact"       # bob untouched
    assert svc.handle(request(a2, ra2, tenant="alice"))["quality"] == \
        "cache:exact"       # alice's newest survived
    assert svc.handle(request(a1, ra1, tenant="alice"))["quality"] == \
        "full"              # alice's oldest was the victim
    assert int(svc.registry.value(
        "raft_tenant_cache_evictions_total", tenant="alice")) >= 1


def test_ttl_expiry_under_fakeclock(tiny_params, tiny_cfg):
    clock = FakeClock()
    svc = make_service(tiny_params, tiny_cfg, clock=clock,
                       cache_ttl_ms=5_000.0)
    la, ra = make_pair(0)
    svc.handle(request(la, ra))
    assert svc.handle(request(la, ra))["quality"] == "cache:exact"
    clock.sleep(60.0)  # way past the 5 s TTL
    r = svc.handle(request(la, ra))
    assert r["quality"] == "full"  # expired: recomputed
    assert int(svc.registry.value("raft_cache_expired_total")) >= 1
    assert svc.cache.status()["entries"] == 1  # the fresh re-deposit


def test_byte_cap_accounting_and_eviction_to_zero(tiny_params, tiny_cfg):
    """The byte budget is a hard bound throughout a deposit storm, the
    gauge tracks the accounted truth, and drop_all() zeroes it."""
    svc = make_service(tiny_params, tiny_cfg)
    cache = svc.cache
    cache.max_bytes = 40_000       # ~3 entries
    cache.per_tenant = 40_000
    for i in range(8):
        la, ra = make_pair(100 + i)
        svc.handle(request(la, ra, rid=i))
        assert cache.status()["bytes"] <= cache.max_bytes
        assert int(svc.registry.value("raft_cache_bytes")) == \
            cache.status()["bytes"]
    st = cache.status()
    assert st["evictions"] >= 5 and st["entries"] >= 1
    assert cache.drop_all() == st["entries"]
    st = cache.status()
    assert st["entries"] == 0 and st["bytes"] == 0
    assert int(svc.registry.value("raft_cache_bytes")) == 0
    assert int(svc.registry.value("raft_cache_entries")) == 0


def test_oversize_entry_refused(tiny_params, tiny_cfg):
    svc = make_service(tiny_params, tiny_cfg)
    svc.cache.max_bytes = 100  # smaller than any entry
    la, ra = make_pair(0)
    svc.handle(request(la, ra))
    st = svc.cache.status()
    assert st["entries"] == 0 and st["deposits_refused"] >= 1


# ---------------------------------------------------------------------------
# Near tier.
# ---------------------------------------------------------------------------


def test_near_tier_disabled_at_zero_tol(tiny_params, tiny_cfg):
    """tolerance=0 means fully disabled: no seed stamping, no near
    counters, the sequential path keeps its classic (non-segmented)
    route."""
    svc = make_service(tiny_params, tiny_cfg)  # near_tol defaults 0
    assert not svc.cache.wants_flow
    la, ra = make_pair(0)
    svc.handle(request(la, ra))
    req = request(perturb(la), ra)
    r = svc.handle(req)
    assert r["quality"] == "full"
    assert "_flow_init" not in req and "_cache_warm" not in req
    assert int(svc.registry.value("raft_cache_near_hits_total")) == 0


def test_near_tier_sequential_warm_label(tiny_params, tiny_cfg):
    """Sequential near hit: a perturbed duplicate is seeded from the
    stored neighbor's 1/8-res flow through prepare_warm, exits through
    the convergence monitor, and is labeled warm:cache:k with k == the
    iterations actually run.  Stream metrics stay untouched — the seed
    is the cache's, not a stream session's."""
    svc = make_service(tiny_params, tiny_cfg, cache_near_tol=8.0)
    assert svc.cache.wants_flow
    la, ra = make_pair(0)
    cold = svc.handle(request(la, ra))
    assert cold["quality"] == "full"
    assert svc.cache.status()["entries"] == 1
    req = request(perturb(la), ra, converge_tol=1e9)
    r = svc.handle(req)
    assert r["status"] == "ok"
    assert r["quality"].startswith("warm:cache:"), r["quality"]
    assert int(r["quality"].rsplit(":", 1)[1]) == r["iters"]
    assert r["iters"] < 4  # converged early — fewer than valid_iters
    assert req.get("_cache_warm") is True
    assert int(svc.registry.value("raft_cache_near_hits_total")) == 1
    assert int(svc.registry.value("raft_stream_warm_joins_total")) == 0
    assert int(svc.registry.value("raft_stream_converged_total")) == 0
    doc = svc.session.usage.doc()
    assert doc["by_tenant"]["default"]["cache"]["near_hits"] == 1
    # a warm-seeded response is never deposited as an exact entry
    assert svc.cache.status()["entries"] == 1


def test_near_tier_batched_warm_label(tiny_params, tiny_cfg):
    svc = make_service(tiny_params, tiny_cfg, max_batch=2,
                       cache_near_tol=8.0).start()
    try:
        la, ra = make_pair(0)
        assert svc.submit(request(la, ra)).result(
            timeout=300)["quality"] == "full"
        r = svc.submit(request(perturb(la), ra,
                               converge_tol=1e9)).result(timeout=300)
        assert r["quality"].startswith("warm:cache:")
        assert int(r["quality"].rsplit(":", 1)[1]) == r["iters"]
        assert int(svc.registry.value(
            "raft_stream_warm_joins_total")) == 0
        # deck tick rows carry the cumulative hit column
        ticks = [t for t in svc.session.deck.snapshot()
                 if t["kind"] == "tick"]
        assert ticks and all("cache_hits" in t for t in ticks)
        exact = svc.submit(request(la, ra)).result(timeout=300)
        assert exact["quality"] == "cache:exact"
    finally:
        svc.stop()


def test_near_tier_respects_tenant_and_tolerance(tiny_params, tiny_cfg):
    """A neighbor is only a neighbor within the SAME tenant and within
    the signature tolerance — a different tenant's scene or a genuinely
    different image never seeds."""
    svc = make_service(tiny_params, tiny_cfg, cache_near_tol=3.0)
    la, ra = make_pair(0)
    svc.handle(request(la, ra, tenant="alice"))
    # same bytes-ish, wrong tenant: cold
    req = request(perturb(la), ra, tenant="bob", converge_tol=1e9)
    assert "warm" not in svc.handle(req)["quality"]
    # right tenant, unrelated image (distance >> tol): cold
    lz, rz = make_pair(99)
    req = request(lz, rz, tenant="alice", converge_tol=1e9)
    r = svc.handle(req)
    assert not r["quality"].startswith("warm:cache:")
    # right tenant, tiny perturbation: warm
    req = request(perturb(la, sigma=1.0), ra, tenant="alice",
                  converge_tol=1e9)
    assert svc.handle(req)["quality"].startswith("warm:cache:")


def test_signature_math():
    """The block-mean signature and its distance, and both bit for bit the
    JAX package's on the same padded images."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    sig = block_signature(img)
    assert sig.shape == (16, 16) and sig.dtype == np.float32
    assert signature_distance(sig, sig) == 0.0
    shifted = block_signature(img + 5.0)
    assert signature_distance(sig, shifted) == pytest.approx(5.0, abs=0.1)
    other = block_signature(
        rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32))
    assert signature_distance(sig, other) > 5.0
    assert signature_distance(sig, np.zeros((8, 8))) == float("inf")
    for a, b in ((img, img + 5.0), (img, other_img := rng.uniform(
            0, 255, (1, 64, 96, 3)).astype(np.float32)),
            (np.zeros((1, 32, 40, 3), np.float32), other_img[:, :32, :40])):
        sa, sb = block_signature(a), block_signature(b)
        assert sa.tobytes() == jax_cache.block_signature(a).tobytes()
        assert sb.tobytes() == jax_cache.block_signature(b).tobytes()
        assert signature_distance(sa, sb) == jax_cache.signature_distance(
            jax_cache.block_signature(a), jax_cache.block_signature(b))


# ---------------------------------------------------------------------------
# Churn storm: bounded bytes, flat /metrics (the hygiene regression).
# ---------------------------------------------------------------------------


def test_churn_storm_cannot_grow_bytes_or_metrics(tiny_params, tiny_cfg):
    """200 tenants x 500 deposits against a small budget: cache bytes
    never exceed the cap, and past the usage label bound the /metrics
    exposition is PROVABLY flat (the tenant-label hygiene)."""
    svc = make_service(tiny_params, tiny_cfg)
    cache = svc.cache
    cache.max_bytes = 60_000
    cache.per_tenant = 60_000
    sess = svc.session
    sess.usage.max_tenants = 4  # force the __other__ overflow quickly
    la, ra = make_pair(0)
    # Drive admit/deposit directly (the storm is about the table, not
    # the device): each "request" is a distinct scene for a distinct
    # tenant, stamped through the real admission path.
    baseline_lines = None
    for i in range(500):
        tenant = f"churn-{i % 200}"
        lj = la + np.float32(i % 251)  # distinct bytes per deposit
        req = {"left": lj, "right": ra, "tenant": tenant}
        assert cache.admit(req) is None
        resp = {"status": "ok", "quality": "full",
                "disparity": np.zeros((H, W), np.float32), "iters": 4}
        cache.deposit(req, resp)
        assert cache.status()["bytes"] <= cache.max_bytes
        if i == 20:
            baseline_lines = len(
                svc.metrics_text().splitlines())
    assert baseline_lines is not None
    final_lines = len(svc.metrics_text().splitlines())
    assert final_lines == baseline_lines, (
        f"/metrics grew {baseline_lines} -> {final_lines} under tenant "
        f"churn — a label leak")
    st = cache.status()
    assert st["bytes"] <= cache.max_bytes
    assert st["evictions"] > 0


# ---------------------------------------------------------------------------
# Lifecycle: drain/stop drop, stream interplay.
# ---------------------------------------------------------------------------


def test_drain_drops_cache(tiny_params, tiny_cfg):
    svc = make_service(tiny_params, tiny_cfg, max_batch=2).start()
    la, ra = make_pair(0)
    assert svc.submit(request(la, ra)).result(timeout=300)["status"] == "ok"
    assert svc.cache.status()["entries"] == 1
    assert svc.drain() is True
    st = svc.cache.status()
    assert st["entries"] == 0 and st["bytes"] == 0
    assert int(svc.registry.value("raft_cache_bytes")) == 0


def test_deposit_refused_for_degraded_and_stale(tiny_params, tiny_cfg):
    """Only cold full-quality responses under the live fingerprint are
    stored — refusal is the bit-exactness guarantee."""
    svc = make_service(tiny_params, tiny_cfg)
    cache = svc.cache
    la, ra = make_pair(0)
    req = {"left": la, "right": ra}
    assert cache.admit(req) is None
    # degraded quality: refused
    cache.deposit(req, {"status": "ok", "quality": "reduced_iters:2",
                        "disparity": np.zeros((H, W), np.float32),
                        "iters": 2})
    assert cache.status()["entries"] == 0
    # warm-seeded: refused
    req2 = {"left": la, "right": ra}
    assert cache.admit(req2) is None
    req2["_flow_init"] = np.zeros((1, 8, 8, 1), np.float32)
    cache.deposit(req2, {"status": "ok", "quality": "full",
                         "disparity": np.zeros((H, W), np.float32),
                         "iters": 4})
    assert cache.status()["entries"] == 0
    # fingerprint-stale: refused
    req3 = {"left": la, "right": ra}
    assert cache.admit(req3) is None
    svc.session.breaker.trip("fused_encoders", "test")
    svc.session._rebuild("test")
    cache.deposit(req3, {"status": "ok", "quality": "full",
                         "disparity": np.zeros((H, W), np.float32),
                         "iters": 4})
    assert cache.status()["entries"] == 0
    assert cache.status()["deposits_refused"] == 3


def test_exact_hit_keeps_stream_session_warm(tiny_params, tiny_cfg):
    """A stream member hitting the exact tier still deposits the
    entry's held flow into its stream session — the stream does not go
    cold just because the answer came for free."""
    svc = make_service(tiny_params, tiny_cfg, max_batch=2,
                       cache_near_tol=8.0).start()
    try:
        la, ra = make_pair(0)
        r1 = svc.submit(request(la, ra, tenant="cam",
                                stream="s1")).result(timeout=300)
        assert r1["status"] == "ok"
        # identical frame 2: exact hit, but the session must stay warm
        r2 = svc.submit(request(la, ra, tenant="cam",
                               stream="s1")).result(timeout=300)
        assert r2["quality"] == "cache:exact"
        # perturbed frame 3 on the same stream: the SESSION seed wins
        # (stream warm join), proving the hit's deposit kept it warm
        req3 = request(perturb(la), ra, tenant="cam", stream="s1",
                       converge_tol=1e9)
        r3 = svc.submit(req3).result(timeout=300)
        assert r3["status"] == "ok"
        assert r3["quality"].startswith("converged:"), r3["quality"]
        assert int(svc.registry.value(
            "raft_stream_warm_joins_total")) == 1
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# Disk spill (RAFT_CACHE_DIR).
# ---------------------------------------------------------------------------


def test_disk_spill_roundtrip(tiny_params, tiny_cfg, tmp_path):
    """An entry evicted from RAM spills to RAFT_CACHE_DIR and a later
    exact match promotes it back — served cache:exact, bit-identical."""
    svc = make_service(tiny_params, tiny_cfg,
                       cache_dir=str(tmp_path / "spill"))
    cache = svc.cache
    cache.max_bytes = 16_000   # one entry at a time
    cache.per_tenant = 16_000
    la, ra = make_pair(0)
    lb, rb = make_pair(1)
    cold_a = svc.handle(request(la, ra))
    svc.handle(request(lb, rb))   # evicts A -> spilled to disk
    assert int(svc.registry.value("raft_cache_spills_total")) == 1
    assert cache.status()["disk"]["bytes"] > 0
    r = svc.handle(request(la, ra))
    assert r["quality"] == "cache:exact"
    assert r["disparity"].tobytes() == cold_a["disparity"].tobytes()
    assert int(svc.registry.value("raft_cache_disk_hits_total")) == 1


def test_disk_spill_ttl_and_budget(tiny_params, tiny_cfg, tmp_path):
    clock = FakeClock()
    svc = make_service(tiny_params, tiny_cfg, clock=clock,
                       cache_dir=str(tmp_path / "spill"),
                       cache_ttl_ms=5_000.0)
    cache = svc.cache
    cache.max_bytes = 16_000
    cache.per_tenant = 16_000
    la, ra = make_pair(0)
    lb, rb = make_pair(1)
    svc.handle(request(la, ra))
    svc.handle(request(lb, rb))   # A spilled
    clock.sleep(60.0)             # past the TTL on the session clock
    r = svc.handle(request(la, ra))
    assert r["quality"] == "full"  # expired spill is a miss + unlink
    spill_dir = tmp_path / "spill"
    # budget prune: disk bytes stay bounded by max_bytes
    for i in range(6):
        li, ri = make_pair(50 + i)
        svc.handle(request(li, ri))
    disk_bytes = sum(f.stat().st_size for f in spill_dir.glob("*.npz"))
    assert disk_bytes <= cache.max_bytes


def test_submit_not_running_beats_cache(tiny_params, tiny_cfg):
    """submit()'s lifecycle contract survives the cache: a stopped (or
    never-started) service rejects not_running even for bytes it could
    answer from the store — a service must not keep serving from the
    grave."""
    svc = make_service(tiny_params, tiny_cfg, max_batch=2).start()
    la, ra = make_pair(0)
    assert svc.submit(request(la, ra)).result(timeout=300)["status"] == "ok"
    svc.stop()
    # Simulate a still-warm store on a stopped service (drop_all cleared
    # RAM; a RAFT_CACHE_DIR spill would survive exactly like this).
    req = {"left": la.copy(), "right": ra.copy()}
    assert svc.cache.admit(req) is None
    svc.cache.deposit(req, {"status": "ok", "quality": "full",
                            "disparity": np.zeros((H, W), np.float32),
                            "iters": 4})
    assert svc.cache.status()["entries"] == 1
    r = svc.submit(request(la, ra)).result(timeout=10)
    assert r["status"] == "rejected" and r["code"] == "not_running", r


def test_disk_promotion_respects_shrunk_budget(tiny_params, tiny_cfg,
                                               tmp_path):
    """A spill written under a larger budget than the current one is
    served once but never promoted — raft_cache_bytes can never exceed
    RAFT_CACHE_BYTES, restart-with-smaller-budget included."""
    spill = str(tmp_path / "spill")
    svc = make_service(tiny_params, tiny_cfg, cache_dir=spill)
    svc.cache.max_bytes = 16_000
    svc.cache.per_tenant = 16_000
    la, ra = make_pair(0)
    lb, rb = make_pair(1)
    cold = svc.handle(request(la, ra))
    svc.handle(request(lb, rb))   # A evicted -> spilled
    # "Restart" with a budget smaller than one entry.
    svc2 = make_service(tiny_params, tiny_cfg, cache_dir=spill)
    svc2.cache.max_bytes = 1_000
    svc2.cache.per_tenant = 1_000
    r = svc2.handle(request(la, ra))
    assert r["quality"] == "cache:exact"  # the spill still serves once
    assert r["disparity"].tobytes() == cold["disparity"].tobytes()
    st = svc2.cache.status()
    assert st["entries"] == 0 and st["bytes"] == 0  # never promoted


def test_corrupt_spill_is_a_miss(tiny_params, tiny_cfg, tmp_path):
    svc = make_service(tiny_params, tiny_cfg,
                       cache_dir=str(tmp_path / "spill"))
    cache = svc.cache
    cache.max_bytes = 16_000
    cache.per_tenant = 16_000
    la, ra = make_pair(0)
    lb, rb = make_pair(1)
    svc.handle(request(la, ra))
    svc.handle(request(lb, rb))
    for f in (tmp_path / "spill").glob("*.npz"):
        f.write_bytes(b"garbage")
    r = svc.handle(request(la, ra))
    assert r["status"] == "ok" and r["quality"] == "full"


# ---------------------------------------------------------------------------
# The /healthz block and wire-facing surface.
# ---------------------------------------------------------------------------


def test_status_block_and_healthz(tiny_params, tiny_cfg):
    svc = make_service(tiny_params, tiny_cfg)
    la, ra = make_pair(0)
    svc.handle(request(la, ra))
    svc.handle(request(la, ra))
    doc = svc.status()
    cb = doc["cache"]
    assert cb["enabled"] and cb["hits"] == 1 and cb["misses"] == 1
    assert cb["hit_ratio"] == pytest.approx(0.5)
    assert cb["entries"] == 1 and cb["bytes"] > 0
    # the block is JSON-serializable (the /healthz contract)
    import json
    json.dumps(doc, default=str)


def test_gl002_sensitivity_env_reads_are_literal():
    """The four RAFT_CACHE_* reads in serve/cache.py are literal
    os.environ reads (the knob registry's cross-check, which collects the
    port's literal RAFT_* names, depends on seeing them)."""
    import inspect

    cache_mod = pt_cache
    src = inspect.getsource(cache_mod)
    for knob in ("RAFT_CACHE_BYTES", "RAFT_CACHE_TTL_MS",
                 "RAFT_CACHE_NEAR_TOL", "RAFT_CACHE_DIR"):
        assert f'os.environ.get("{knob}"' in src, knob


# ---------------------------------------------------------------------------
# Concurrent-writer safety: two instances sharing one RAFT_CACHE_DIR must
# never publish a torn entry.
# ---------------------------------------------------------------------------


def test_spill_tmp_names_unique_per_writer(tiny_params, tiny_cfg,
                                           tmp_path, monkeypatch):
    """The atomic tmp+rename path must use a UNIQUE tmp name per writer:
    with the old fixed "<path>.tmp" suffix, two caches spilling the same
    key concurrently would open the SAME tmp file — writer B's open()
    truncates the bytes writer A is mid-np.savez on, and A's os.replace
    then publishes B's torn prefix under the final name.  Also pinned:
    tmp names never end in ".npz", so the disk accounting scans and the
    prune can never count or load an in-progress write."""
    import os as os_mod

    from raft_stereo_tpu_torch.serve.cache import CacheEntry

    spill = str(tmp_path / "spill")
    svc = make_service(tiny_params, tiny_cfg, cache_dir=spill)
    c1 = svc.cache
    c2 = ResponseCache(svc.session, max_bytes=64 << 20, cache_dir=spill)

    recorded = []
    real_replace = os_mod.replace

    def spy(src, dst, *a, **kw):
        recorded.append((src, dst))
        return real_replace(src, dst, *a, **kw)

    monkeypatch.setattr("os.replace", spy)

    key = ("exact", "contested", 1)
    sig = np.zeros(64, np.float32)

    def entry(cache, fill):
        return CacheEntry(key, "default", "default", sig,
                          np.full((H, W), fill, np.float32), None,
                          None, 4, 0.0)

    c1._spill(entry(c1, 1.0))
    c2._spill(entry(c2, 2.0))
    spill_writes = [(s, d) for s, d in recorded
                    if d.startswith(spill)]
    assert len(spill_writes) == 2
    (src1, dst1), (src2, dst2) = spill_writes
    assert dst1 == dst2, "same key must target the same final path"
    assert src1 != src2, (
        "two writers shared one tmp path — the torn-entry race")
    for src in (src1, src2):
        assert not src.endswith(".npz"), (
            "a tmp name ending in .npz is visible to the disk scans")
    leftovers = [f for f in os_mod.listdir(spill) if ".tmp" in f]
    assert leftovers == [], leftovers


def test_two_caches_racing_deposits_never_serve_torn(tiny_params,
                                                     tiny_cfg,
                                                     tmp_path):
    """Two ResponseCache objects hammer the SAME key's spill path from
    concurrent threads; whatever write wins, the published file must
    always load as a COMPLETE entry (one writer's payload, never an
    interleaving) and the promote path must serve it."""
    import threading as threading_mod

    from raft_stereo_tpu_torch.serve.cache import CacheEntry

    spill = str(tmp_path / "spill")
    svc = make_service(tiny_params, tiny_cfg, cache_dir=spill)
    caches = [svc.cache,
              ResponseCache(svc.session, max_bytes=64 << 20,
                            cache_dir=spill)]
    key = ("exact", "contested", 2)
    sig = np.zeros(64, np.float32)
    fills = {0: 10.0, 1: 20.0}
    errors = []

    def writer(idx):
        cache = caches[idx]
        try:
            for _ in range(25):
                cache._spill(CacheEntry(
                    key, "default", "default", sig,
                    np.full((H, W), fills[idx], np.float32), None,
                    None, 4, 0.0))
        except Exception as e:  # noqa: BLE001 — fail the test with it
            errors.append(e)

    threads = [threading_mod.Thread(target=writer, args=(i,))
               for i in (0, 1) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors

    # The published file is ONE complete payload — loadable, correct
    # key, disparity uniformly one writer's fill value.
    path = caches[0]._path_for(key)
    with np.load(path) as z:
        import json as json_mod
        meta = json_mod.loads(bytes(z["meta"]).decode())
        assert meta["key"] == repr(key)
        disp = np.array(z["disparity"])
    assert disp.shape == (H, W)
    assert disp.min() == disp.max() and disp.min() in fills.values(), (
        "torn spill: interleaved bytes from two writers")
    # and the promote path serves it
    entry = caches[1]._disk_lookup(key, "default", "default", now=1.0)
    assert entry is not None and entry.iters == 4
    assert [f for f in (tmp_path / "spill").iterdir()
            if ".tmp" in f.name] == []
