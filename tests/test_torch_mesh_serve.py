"""The port's pod serving (serve/session.py ``mesh_data``) on the CPU.

The counterpart of the JAX package's tests/test_mesh_serve.py and of the
mesh cases of tests/test_heal.py. A CPU session's data mesh lists the CPU n
times (the JAX tests' fake host devices): each shard program runs eagerly
with the kernels' plain versions, so every mesh mechanism runs here except
the CUDA graphs (chip_smoke.py phase 12 on the card). Tiny model (TINY),
40x60 pairs bucketed to 64x64, 4 iterations in 2 segments, fp32,
``FakeClock``.

- Knobs: the named errors, the kill switch keeping keys byte-identical.
- Rows: a 2-device mesh's rows at buckets 4 and 8 equal, by
  ``torch.equal``, a one-device session's rows at bucket b/2 (within one
  batch width a row is bit for bit the same whatever its batchmates), pad
  rows and a warm + cold tick included.
- Quarantine, chip affinity and warm migration, the device seconds' exact
  partition, per-chip capacity, shrink and re-grow bit for bit with no new
  warm record, the flap cap, a device-hang bounce through the service with
  one chip's probe parked.
- The JAX package's scheduler on a ``mesh_data=2`` session against the
  port's, on the same weights: within 1e-4 px.
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

from raft_stereo_tpu_torch import RAFTStereo, RAFTStereoConfig, init_raft_stereo
from raft_stereo_tpu_torch.analysis.knobs import ENV_KNOBS
from raft_stereo_tpu_torch.faults import ChaosPlan, FakeClock, ServeFaultPlan
from raft_stereo_tpu_torch.models import (ShardedCarry, shard_rows, stack_refinement_states,
                                          take_refinement_rows)
from raft_stereo_tpu_torch.obs.capacity import saturation_per_chip
from raft_stereo_tpu_torch.obs.fleet import rollup
from raft_stereo_tpu_torch.serve import (BatchScheduler, InferenceSession, ServiceConfig,
                                         SessionConfig, StereoService, Supervisor)
from raft_stereo_tpu_torch.serve import session as session_mod
from raft_stereo_tpu_torch.serve.session import (_device_list, resolve_mesh_fallback,
                                                 resolve_serve_mesh_data)
from raft_stereo_tpu_torch.serve.stream import StreamManager
from raft_stereo_tpu_torch.serve.validate import AdmissionConfig, validate_pair
from raft_stereo_tpu_torch.transplant import load_state_dict, params_from_jax

pytestmark = pytest.mark.serve

TINY = dict(n_gru_layers=1, hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
H, W = 40, 60  # not multiples of 32: every request really is padded
MESH_VARS = ("RAFT_SERVE_MESH_DATA", "RAFT_SERVE_MESH_FALLBACK", "RAFT_BATCH_BUCKETS",
             "RAFT_HEAL", "RAFT_HEAL_BACKOFF_MS", "RAFT_HEAL_BACKOFF_MAX_MS",
             "RAFT_HEAL_FLAP_CAP", "RAFT_HEAL_WINDOW_MS")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    for knob in ENV_KNOBS + MESH_VARS:
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
             rng.uniform(0, 255, (H, W, 3)).astype(np.float32)) for _ in range(8)]


def make_session(model, cfg, *, mesh_data=None, max_batch=4, batch_buckets=(), plan=None,
                 **kw):
    scfg = SessionConfig(valid_iters=4, segments=2, max_batch=max_batch,
                         batch_buckets=batch_buckets, canary=False, mesh_data=mesh_data, **kw)
    return InferenceSession(model, cfg, scfg, device="cpu", fault_plan=plan, clock=FakeClock())


@pytest.fixture(scope="module")
def sessions(tiny_model, tiny_cfg):
    """Shared fault-free sessions (their programs accumulate across the
    read-only tests): a 2-device mesh at max_batch 4 and 8, and one device
    at the half buckets."""
    return {"mesh4": make_session(tiny_model, tiny_cfg, mesh_data=2),
            "one2": make_session(tiny_model, tiny_cfg, max_batch=2, batch_buckets=(2,)),
            "mesh8": make_session(tiny_model, tiny_cfg, mesh_data=2, max_batch=8,
                                  batch_buckets=(1, 8)),
            "one4": make_session(tiny_model, tiny_cfg, max_batch=4, batch_buckets=(4,))}


def canonical(pair):
    return validate_pair(pair[0], pair[1], AdmissionConfig())


def make_request(pair, rid=None, tenant=None, **extra):
    left, right = canonical(pair)
    req = {"id": rid, "left": left, "right": right}
    if tenant is not None:
        req["tenant"] = tenant
    req.update(extra)
    return req


def run_sched(session, requests, *, stream=None):
    """Drive a scheduler until every request is answered; every joiner is
    uploaded before the first tick, so they join together."""
    out = {}
    sched = BatchScheduler(session, resolve=lambda rq, rs: out.__setitem__(rq["id"], rs),
                           stream=stream)
    for rq in requests:
        sched.submit(rq)
    for bucket in sched._buckets.values():
        for row in list(bucket.pending):
            assert row.uploaded.wait(timeout=30)
    spins = 0
    while len(out) < len(requests):
        if not sched.run_tick():
            time.sleep(0.002)
        spins += 1
        assert spins < 4000, "scheduler made no progress"
    status = sched.status()
    sched.shutdown()
    return out, status


def series_sum(registry, name, **labels):
    return int(sum(v for lbl, v in registry.series(name)
                   if all(lbl.get(k) == want for k, want in labels.items())))


def assert_equal_rows(got, want, rids, what):
    for rid in rids:
        assert got[rid]["status"] == want[rid]["status"] == "ok", (what, rid)
        assert got[rid]["quality"] == want[rid]["quality"], (what, rid)
        assert torch.equal(torch.from_numpy(got[rid]["disparity"]),
                           torch.from_numpy(want[rid]["disparity"])), (what, rid)


# -- knobs and the fallback ------------------------------------------------------------


def test_mesh_knob_resolution_named_errors(monkeypatch):
    assert resolve_serve_mesh_data() == 1
    monkeypatch.setenv("RAFT_SERVE_MESH_DATA", "nope")
    with pytest.raises(ValueError, match="RAFT_SERVE_MESH_DATA"):
        resolve_serve_mesh_data()
    monkeypatch.setenv("RAFT_SERVE_MESH_DATA", "0")
    with pytest.raises(ValueError, match=">= 1"):
        resolve_serve_mesh_data()
    monkeypatch.setenv("RAFT_SERVE_MESH_DATA", "4")
    assert resolve_serve_mesh_data() == 4
    assert resolve_serve_mesh_data(2) == 2  # an explicit value wins
    with pytest.raises(ValueError, match=">= 1"):
        resolve_serve_mesh_data(0)
    assert resolve_mesh_fallback() is False
    for raw in ("1", "true", "yes"):
        monkeypatch.setenv("RAFT_SERVE_MESH_FALLBACK", raw)
        assert resolve_mesh_fallback() is True
    monkeypatch.setenv("RAFT_SERVE_MESH_FALLBACK", "0")
    assert resolve_mesh_fallback() is False
    with pytest.raises(ValueError, match="mesh_data"):
        SessionConfig(mesh_data=0)


def test_mesh_devices_listed_and_counted(tiny_model, tiny_cfg):
    """The CPU listed n times; an explicit list (a device may repeat) is
    taken in order; on CUDA with fewer cards than n the session raises,
    naming the count (none here). A list of another device type than the
    session's, or a list given to a session with no mesh, raises."""
    assert _device_list(torch.device("cpu"), 3) == [torch.device("cpu")] * 3
    assert _device_list(torch.device("cpu"), 2, ["cpu", "cpu", "cpu"]) == \
        [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="mesh_data 3 exceeds the 2 available given"):
        _device_list(torch.device("cpu"), 3, ["cpu", "cpu"])
    with pytest.raises(ValueError, match=r"mesh_devices \['cuda:0'\] are not cpu devices"):
        _device_list(torch.device("cpu"), 2, ["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="mesh_devices is given but the session has no data"):
        InferenceSession(tiny_model, tiny_cfg, SessionConfig(canary=False), device="cpu",
                         mesh_devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="mesh_data 2 exceeds the 0 available cuda"):
            _device_list(torch.device("cuda"), 2)


def test_mesh_fallback_keeps_single_device_keys(monkeypatch, tiny_model, tiny_cfg):
    """The kill switch forces one device with keys byte-identical to a
    session that never had a mesh."""
    plain = make_session(tiny_model, tiny_cfg, batch_buckets=(1, 4))
    monkeypatch.setenv("RAFT_SERVE_MESH_DATA", "4")
    monkeypatch.setenv("RAFT_SERVE_MESH_FALLBACK", "1")
    off = make_session(tiny_model, tiny_cfg, batch_buckets=(1, 4))
    assert not off.mesh_active and off.mesh_chips == 1
    assert off.batch_buckets == plain.batch_buckets == (1, 4)
    k_off = off.cache_key("advance", 64, 64, 2, b=4)
    assert repr(k_off).encode() == repr(plain.cache_key("advance", 64, 64, 2, b=4)).encode()
    assert len(k_off) == 6
    assert off.mesh_status()["enabled"] is False and off.mesh_status()["devices"] == []


def test_mesh_session_activates_and_keys(sessions):
    sess, plain = sessions["mesh4"], sessions["one4"]
    assert sess.mesh_active and sess.mesh_chips == 2
    assert sess.batch_buckets == (2, 4)         # (1, 2, 4) rounded up to multiples of 2
    assert sessions["mesh8"].batch_buckets == (2, 8)
    st = sess.mesh_status()
    assert st["enabled"] and st["n_data"] == st["base_n_data"] == 2
    assert st["epoch"] == 0 and st["quarantined"] == [] and st["live"] == [0, 1]
    assert [d["device"] for d in st["devices"]] == ["cpu", "cpu"]
    k = sess.cache_key("advance", 64, 64, 2, b=4)
    assert k[-1] == ("mesh", 2, 0)
    assert plain.cache_key("advance", 64, 64, 2, b=4) == k[:-1]
    assert len(sess.cache_key("full", 64, 64, 4, b=1)) == 6  # b=1 does not split
    assert sess.fingerprint_id() == plain.fingerprint_id()
    assert sess.config_doc()["mesh"] == st and sess.status()["mesh"] == st


def test_sharded_carry_gathers_and_joins_part_by_part():
    """Gathers and joins leave every row in its part; ``shard_rows``
    passes a carry already in the shard layout through, copying nothing."""
    def carry(rows):
        t = torch.tensor(rows, dtype=torch.float32).reshape(-1, 1, 1, 1)
        return {"coords1": t, "net": [t * 10]}
    a, b = carry([0, 1]), carry([2, 3])
    sc = stack_refinement_states([ShardedCarry([a]), b])
    assert isinstance(sc, ShardedCarry) and sc.widths == (2, 2)
    got = take_refinement_rows(sc, [3, 0, 1, 0])
    assert got.widths == (1, 3)
    assert got.parts[1]["coords1"].flatten().tolist() == [0, 1, 0]
    parts = shard_rows(got, [torch.device("cpu")] * 2, 2)
    assert [p["coords1"].flatten().tolist() for p in parts] == [[3, 0], [1, 0]]
    assert [p["net"][0].flatten().tolist() for p in parts] == [[30, 0], [10, 0]]
    laid = ShardedCarry(parts)
    again = shard_rows(laid, [torch.device("cpu")] * 2, 2)
    assert all(x is y for x, y in zip(again, parts))


# -- rows: a mesh at bucket b against one device at b/2 ----------------------------------


@pytest.mark.parametrize("case", ["b4", "b4_pad", "b8", "warm_cold"])
def test_mesh_rows_equal_one_device_rows(case, sessions, pairs, tiny_cfg):
    """Each shard of a bucket-b mesh program runs b/2 rows: the mesh's rows
    are the one-device session's at bucket b/2, by ``torch.equal`` (pad
    rows beside them, a warm and two cold joiners in one tick)."""
    if case == "warm_cold":
        mesh, one = sessions["mesh4"], sessions["one2"]
        left, right = canonical(pairs[0])
        ph, pw = mesh.padder_for(left.shape).padded_shape
        f = tiny_cfg.downsample_factor
        flow = np.random.default_rng(9).uniform(
            -1, 1, (1, ph // f, pw // f, 1)).astype(np.float32)

        def requests():
            return ([{"id": "w", "left": left, "right": right, "_flow_init": flow}]
                    + [make_request(pairs[1 + i], rid=f"c{i}") for i in range(2)])
        warm0 = int(mesh.registry.value("raft_stream_warm_joins_total"))
        want, _ = run_sched(one, requests(), stream=StreamManager(one))
        got, _ = run_sched(mesh, requests(), stream=StreamManager(mesh))
        assert_equal_rows(got, want, ("w", "c0", "c1"), case)
        assert int(mesh.registry.value("raft_stream_warm_joins_total")) == warm0 + 1
        assert got["w"]["disparity"].tobytes() != got["c0"]["disparity"].tobytes()
        return
    mesh, one, n = {"b4": (sessions["mesh4"], sessions["one2"], 4),
                    "b4_pad": (sessions["mesh4"], sessions["one2"], 3),
                    "b8": (sessions["mesh8"], sessions["one4"], 8)}[case]
    want, _ = run_sched(one, [make_request(p, rid=i) for i, p in enumerate(pairs[:n])])
    pads0 = series_sum(mesh.registry, "raft_sched_pad_rows_total")
    got, st = run_sched(mesh, [make_request(p, rid=i) for i, p in enumerate(pairs[:n])])
    assert_equal_rows(got, want, range(n), case)
    bb = mesh.batch_bucket(n)
    assert st["ticks_by_bucket"].get(str(bb), 0) >= 2
    # Pad rows are counted as pads, never as occupancy.
    assert series_sum(mesh.registry, "raft_sched_pad_rows_total") - pads0 == 2 * (bb - n)
    assert st["occupancy_hist"].get(str(n), 0) >= 2
    assert any(c.endswith("/mesh2") for c in mesh.status()["programs"]["cached"])
    assert any(int(t.get("chips", 1)) == 2 for t in mesh.deck.snapshot())


# -- quarantine, affinity, books -------------------------------------------------------


def test_mesh_quarantine_shrink_and_rekey(tiny_model, tiny_cfg, pairs):
    sess = make_session(tiny_model, tiny_cfg, mesh_data=4, max_batch=4)
    assert sess.batch_buckets == (4,)
    k0 = sess.cache_key("advance", 64, 64, 2, b=4)
    assert k0[-1] == ("mesh", 4, 0)
    # Chip 2 of 4 hangs: 3 survivors, the largest divisor of 4 that fits is 2.
    assert sess.quarantine_chip(2)
    assert sess.mesh_chips == 2
    st = sess.mesh_status()
    assert st["quarantined"] == [2] and st["epoch"] == 1 and st["live"] == [0, 1]
    assert [d["chip"] for d in st["devices"] if d["quarantined"]] == [2]
    k1 = sess.cache_key("advance", 64, 64, 2, b=4)
    assert k1[-1] == ("mesh", 2, 1) and k1 != k0
    assert not sess.quarantine_chip(2)
    assert not sess.quarantine_chip(99)
    assert int(sess.registry.value("raft_mesh_chips_quarantined_total")) == 1
    assert int(sess.registry.value("raft_mesh_chips")) == 2
    out, _ = run_sched(sess, [make_request(p, rid=i) for i, p in enumerate(pairs[:4])])
    assert all(out[i]["status"] == "ok" for i in range(4))
    shards = sess.program_shards("advance", 64, 64, 2, b=4)
    assert [s["chip"] for s in shards] == [0, 1]
    # Down to one healthy chip: a one-chip mesh keeps placement on it.
    assert sess.quarantine_chip(0) and sess.quarantine_chip(1)
    assert sess.mesh_chips == 1 and sess.mesh_active
    assert sess.mesh_status()["quarantined"] == [0, 1, 2]
    assert sess.mesh_status()["live"] == [3]


def test_mesh_chip_affinity_and_warm_migration(sessions, tiny_model, tiny_cfg, pairs):
    sess = sessions["mesh4"]
    manager = StreamManager(sess)
    left, right = canonical(pairs[0])
    ph, pw = sess.padder_for(left.shape).padded_shape
    f = tiny_cfg.downsample_factor

    def admit(cam, m=manager):
        req = {"id": cam, "left": left, "right": right, "stream": cam}
        m.admit(req)
        return req

    r_a, r_b = admit("cam-a"), admit("cam-b")
    assert {r_a["_chip"], r_b["_chip"]} == {0, 1}
    assert manager.status()["by_chip"] == {"0": 1, "1": 1}
    # The scheduler keeps a chip's rows together: joiners sorted by chip.
    sched = BatchScheduler(sess, resolve=lambda rq, rs: None)
    for i, chip in enumerate((1, 0, 1, 0)):
        sched.submit(make_request(pairs[i], rid=i, _chip=chip))
    for row in list(sched._buckets[(ph, pw)].pending):
        assert row.uploaded.wait(timeout=30)
    sched.run_tick()
    rows = sched._buckets[(ph, pw)].rows
    assert [r.request["_chip"] for r in rows] == [0, 0, 1, 1]
    assert [r.request["id"] for r in rows] == [1, 3, 0, 2]
    sched.drain()
    sched.shutdown()
    # A served frame's flow deposited into the chip-1 session.
    victim = r_a if r_a["_chip"] == 1 else r_b
    victim["_stream_flow"] = np.ones((1, ph // f, pw // f, 1), np.float32)
    victim["_stream_shape"] = (ph, pw)
    manager.deposit(victim, {"status": "ok"})
    # Chip 1 quarantined, the mesh one wide: its session moves and stays warm.
    migrated = manager.migrate_off_chips([1], 1)
    assert migrated >= 1
    assert manager.status()["by_chip"] == {"0": 1}
    nxt = admit(victim["id"])
    assert nxt.get("_chip") is None and nxt.get("_flow_init") is not None
    # On a mesh still two wide a migrated session gets a new shard, and a
    # re-grown mesh re-pins a parked one.
    m2 = StreamManager(sess)
    q = admit("x", m2)
    assert q["_chip"] == 0
    assert m2.migrate_off_chips([0], 2) == 1
    assert admit("x", m2)["_chip"] in (0, 1)
    assert m2.migrate_off_chips([0, 1], 1) == 1
    assert m2.repin_unplaced(2) == 1 and admit("x", m2)["_chip"] in (0, 1)


def test_mesh_device_seconds_partition_exactly(tiny_model, tiny_cfg, pairs):
    """One call spanning two chips is one wall interval: the tenants'
    integer-ns device seconds sum to the total exactly, and the chips'
    busy seconds are that interval each, never split nor doubled."""
    sess = make_session(tiny_model, tiny_cfg, mesh_data=2,
                        plan=ServeFaultPlan(slow_forwards={i: 0.25 for i in range(128)}))
    out, st = run_sched(sess, [make_request(pairs[i], rid=i, tenant=f"t{i % 2}")
                               for i in range(3)])
    assert all(out[i]["status"] == "ok" for i in range(3))
    ticks = sess.deck.snapshot()
    assert any(int(t.get("chips", 1)) > 1 for t in ticks)
    assert st["pad_waste"] > 0 and st["occupancy_hist"].get("3", 0) >= 1
    doc = sess.usage.doc()
    assert sum(t["device_ns"] for t in doc["by_tenant"].values()) == doc["device_ns_total"]
    assert doc["device_ns_total"] > 0
    prog_dev_s = sum(v for _, v in sess.registry.series("raft_program_device_seconds_total"))
    assert abs(doc["device_ns_total"] / 1e9 - prog_dev_s) <= max(1e-6, 1e-9 * prog_dev_s)
    rows = saturation_per_chip(ticks, 4, now=sess.clock.now() + 1.0, window_s=60.0)
    assert rows[0]["busy_s"] == pytest.approx(rows[1]["busy_s"]) and rows[0]["busy_s"] > 0
    assert rows[2]["ratio"] is None and rows[3]["ratio"] is None


def test_mesh_capacity_status_per_chip(tiny_model, tiny_cfg, pairs, sessions):
    sess = make_session(tiny_model, tiny_cfg, mesh_data=2)
    out, _ = run_sched(sess, [make_request(pairs[0], rid=0), make_request(pairs[1], rid=1)])
    assert out[0]["status"] == out[1]["status"] == "ok"
    chips = sess.capacity_status()["chips"]
    assert chips["n_data"] == chips["base_n_data"] == 2 and chips["quarantined"] == []
    assert [r["chip"] for r in chips["per_chip"]] == [0, 1]
    assert all(r["quarantined"] is False for r in chips["per_chip"])
    assert chips["per_chip"][0]["ratio"] is not None
    assert sess.registry.value("raft_capacity_chip_saturation", chip="0") == \
        chips["per_chip"][0]["ratio"]
    assert sess.quarantine_chip(1)
    chips2 = sess.capacity_status()["chips"]
    assert chips2["n_data"] == 1 and chips2["quarantined"] == [1]
    row1 = chips2["per_chip"][1]
    assert row1["quarantined"] is True and row1["headroom_rps"] == 0.0
    assert row1["permanent"] is False
    # One device: no chips block.
    assert "chips" not in sessions["one4"].capacity_status()


# -- the recovery plane: re-growth and the flap cap -------------------------------------


def test_mesh_regrow_bitwise_no_new_warm_records(tiny_model, tiny_cfg, pairs):
    sess = make_session(tiny_model, tiny_cfg, mesh_data=2, warmup_shapes=((H, W),))

    def reqs(tag):
        return [make_request(p, rid=f"{tag}{i}") for i, p in enumerate(pairs[:4])]

    want, _ = run_sched(sess, reqs("a"))
    assert sess.quarantine_chip(1) and sess.mesh_chips == 1
    mid, _ = run_sched(sess, reqs("m"))
    assert all(mid[f"m{i}"]["status"] == "ok" for i in range(4))
    base_s = sess.heal_status()["backoff_ms"] / 1e3
    assert sess.heal_mesh() == {"probed": [], "readmitted": [], "failed": []}  # too early
    sess.clock.sleep(base_s + 1.0)
    assert sess.heal_mesh() == {"probed": [1], "readmitted": [1], "failed": []}
    st = sess.mesh_status()
    assert st["n_data"] == 2 and st["quarantined"] == [] and st["epoch"] == 2
    assert series_sum(sess.registry, "raft_heal_chip_probes_total", result="passed") == 1
    assert sess.heal_status()["mttr"] == {"last_s": pytest.approx(base_s + 1.0), "events": 1}
    # The re-admission warmed the new epoch's programs before it returned:
    # the same rows at the same bucket, bit for bit, and no warm record.
    warm0 = sess.deck.status()["warm_records"]
    got, _ = run_sched(sess, reqs("b"))
    for i in range(4):
        assert torch.equal(torch.from_numpy(got[f"b{i}"]["disparity"]),
                           torch.from_numpy(want[f"a{i}"]["disparity"])), i
    assert sess.deck.status()["warm_records"] == warm0


def test_chip_flap_cap_exact(tiny_model, tiny_cfg):
    sess = make_session(tiny_model, tiny_cfg, mesh_data=2)
    hs = sess.heal_status()
    base_s, flap_cap = hs["backoff_ms"] / 1e3, hs["flap_cap"]
    assert flap_cap == 2
    for k in range(flap_cap):
        assert sess.quarantine_chip(1)
        sess.clock.sleep(2 * base_s + 1.0)
        assert sess.heal_mesh()["readmitted"] == [1], k
    assert series_sum(sess.registry, "raft_heal_chips_readmitted_total") == flap_cap
    assert sess.quarantine_chip(1)
    chip = sess.heal_status()["chips"]["1"]
    assert chip["permanent"] is True and chip["readmissions"] == flap_cap
    assert chip["eligible_in_s"] is None
    assert series_sum(sess.registry, "raft_heal_chips_permanent_total") == 1
    sess.clock.sleep(100 * base_s)
    assert sess.heal_mesh() == {"probed": [], "readmitted": [], "failed": []}
    assert not sess.readmit_chip(1)
    st = sess.mesh_status()
    assert st["n_data"] == 1 and st["quarantined"] == [1]


# -- a device hang on a mesh, through the service ----------------------------------------


def test_device_hang_bounce_quarantines_the_parked_chip(tiny_model, tiny_cfg, pairs):
    """A steady advance hangs; the watchdog's bounce probes both chips,
    chip 1's probe stays parked (the plan's ``hang_chips``), so chip 1 alone
    is quarantined, the mesh shrinks to one chip, the request is re-admitted
    and served, and the heal sweep re-grows the mesh once the chip answers."""
    # Ordinals with one warm request first: prepare(0) advance(1) advance(2)
    # epilogue(3); the victim's steady advance is ordinal 5. Its 50 s land on
    # the session clock; the faults clear at 60 s, after the bounce's probes.
    plan = ChaosPlan(hang_invokes={5: 50.0}, hang_chips=(1,), hang_cap_s=20.0,
                     clear_after_ms=60_000.0)
    session = InferenceSession(
        tiny_model, tiny_cfg,
        SessionConfig(valid_iters=4, segments=2, max_batch=4, canary=False, mesh_data=2),
        device="cpu", fault_plan=plan, clock=FakeClock())
    svc = StereoService(session, ServiceConfig(max_queue=16, watchdog_ms=5000.0,
                                               retry_budget=2, supervise=False)).start()
    try:
        left, right = pairs[0]
        assert svc.submit({"id": 0, "left": left, "right": right,
                           "stream": "cam"}).result(timeout=120)["status"] == "ok"
        fut = svc.submit({"id": 1, "left": left, "right": right})
        assert session.faults.wait_hang_entered(1, timeout=30)
        trips = Supervisor(svc, watchdog_s=5.0).check_now()
        assert [t.kind for t in trips] == ["device_hang"]
        r = fut.result(timeout=60)
        assert r["status"] == "ok" and r["retries"] == 1
        mesh = session.mesh_status()
        assert mesh["quarantined"] == [1] and mesh["n_data"] == 1 and mesh["epoch"] == 1
        assert int(svc.registry.value("raft_mesh_chips_quarantined_total")) == 1
        health = svc.status()
        assert health["session"]["mesh"]["quarantined"] == [1]
        assert health["capacity"]["chips"]["quarantined"] == [1]
        assert health["heal"]["chips"]["1"]["quarantined"] is True
        # The fleet's rollup reads the same document: one chip live, one out.
        fleet = rollup([{"uid": "a", "slot": 0, "state": "ready", "doc": health}])
        assert fleet["chips"] == 1 and fleet["chips_quarantined"] == 1
        # The fault clears: a sweep past the chip's backoff re-grows the mesh.
        session.clock.sleep(session.heal_status()["backoff_ms"] / 1e3 + 1.0)
        sweep = svc.heal_sweep()
        assert sweep["mesh"]["readmitted"] == [1] and session.mesh_chips == 2
    finally:
        svc.stop()


def _park(target, *args):
    """Run ``target(*args, parked, release)`` on a daemon thread until it
    sets ``parked``; returns the ``release`` event and the thread."""
    parked, release = threading.Event(), threading.Event()
    t = threading.Thread(target=target, args=(*args, parked, release), daemon=True)
    t.start()
    assert parked.wait(10)
    return release, t


def _replay_parked(dev, parked, release):
    """A replay on a hung device: it shares the device's gate and never
    comes back (until released)."""
    with session_mod._gate(dev).shared():
        parked.set()
        release.wait(60)


def test_parked_replay_holds_up_its_own_device_alone(monkeypatch, tiny_model, tiny_cfg):
    """A replay that never comes back keeps sharing its device's gate. A
    capture on another device goes ahead at once; one on the parked
    device gives up after its wait (``GateTimeout``: capture_failed) and
    lets calls in again; a probe queued behind that capture waits it out
    and reads its chip as healthy; releasing a program whose call is
    parked returns. The CPU session takes the gates here as on the card."""
    monkeypatch.setattr(session_mod, "GATE_WAIT_S", 0.5)
    release, zombie = _park(_replay_parked, "cuda:1")
    try:
        t0 = time.monotonic()
        with session_mod._gate("cuda:0").alone(timeout=session_mod.GATE_WAIT_S):
            pass
        assert time.monotonic() - t0 < 0.4
        with pytest.raises(session_mod.GateTimeout):
            with session_mod._gate("cuda:1").alone(timeout=0.2):
                pass
        assert session_mod._gate("cuda:1")._waiting == 0
        release_call, call = _park(_replay_parked, "cuda:1")  # a later call gets in
        release_call.set()
        call.join(10)
    finally:
        release.set()
        zombie.join(10)

    sess = make_session(tiny_model, tiny_cfg, mesh_data=2)
    monkeypatch.setattr(sess, "_gated", True)
    release, zombie = _park(_replay_parked, "cpu")
    timed_out = threading.Event()

    def capture():
        try:
            with session_mod._gate("cpu").alone(timeout=session_mod.GATE_WAIT_S):
                pass
        except session_mod.GateTimeout:
            timed_out.set()

    cap = threading.Thread(target=capture, daemon=True)
    try:
        assert sess.probe_chips(timeout_s=0.1) == ()  # sharing beside the parked call
        cap.start()
        while session_mod._gate("cpu")._waiting == 0:
            time.sleep(0.001)
        assert sess.probe_chips(timeout_s=0.1) == ()  # behind the capture, then in
        assert timed_out.is_set()
        prog = sess.get_program("advance", 64, 64, 2, b=4)

        def call_parked(parked, release):
            with prog.lock:
                parked.set()
                release.wait(60)

        release_prog, holder = _park(call_parked)
        t0 = time.monotonic()
        prog.release()
        assert time.monotonic() - t0 < 5 and prog.lock.locked()
        release_prog.set()
        holder.join(10)
    finally:
        release.set()
        zombie.join(10)
        cap.join(10)


# -- parity with the JAX package's mesh scheduler ------------------------------------------


def test_mesh_scheduler_matches_jax_mesh_scheduler(pairs):
    """The same four pairs through the JAX BatchScheduler on a
    ``mesh_data=2`` session (two fake host devices) and the port's, fp32,
    over the same weights (the port's seeded weights with the flow head
    tempered, carried to the JAX package and back): disparities within
    1e-4 px, equal labels, keys and tick counts."""
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
    jx = JaxSession(params, jcfg, JaxSessionConfig(valid_iters=4, segments=2, max_batch=4,
                                                   canary=False, mesh_data=2),
                    clock=JaxFakeClock())
    pt = make_session(model, cfg, mesh_data=2)
    assert tuple(jx.batch_buckets) == pt.batch_buckets == (2, 4)
    assert jx.mesh_chips == pt.mesh_chips == 2
    outs, stats = {}, {}
    for name, sess, sched_cls in (("jax", jx, JaxScheduler), ("port", pt, BatchScheduler)):
        out = {}
        sched = sched_cls(sess, resolve=lambda rq, rs, out=out: out.__setitem__(rq["id"], rs))
        for i, p in enumerate(pairs[:4]):
            sched.submit(make_request(p, rid=i))
        for bucket in sched._buckets.values():
            for row in list(bucket.pending):
                assert row.uploaded.wait(timeout=60)
        spins = 0
        while len(out) < 4:
            if not sched.run_tick():
                time.sleep(0.002)
            spins += 1
            assert spins < 4000
        stats[name] = sched.status()
        sched.shutdown()
        outs[name] = out
    assert stats["jax"]["ticks"] == stats["port"]["ticks"] == 2
    for i in range(4):
        a, b = outs["jax"][i], outs["port"][i]
        assert set(a) == set(b), i
        assert (a["status"], a["quality"], a["iters"]) == (b["status"], b["quality"],
                                                          b["iters"]) == ("ok", "full", 4)
        np.testing.assert_allclose(b["disparity"], np.asarray(a["disparity"]), rtol=0,
                                   atol=1e-4, err_msg=str(i))
