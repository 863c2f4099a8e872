"""The port's fleet supervisor (serve/fleet.py) over stub instances.

Mirrors every case of the JAX package's fleet battery (tests/test_fleet.py)
and its two fleet cases of tests/test_heal.py (the restart-budget refill
and its off switch). Every test launches real subprocesses and talks over
real loopback sockets, but the instance is ``tests/fleet_stub.py``, a
stdlib server that speaks the same handshake and /healthz schema, so the
whole lifecycle (launch, probe, route, kill, replace, roll, drain) takes
seconds. The real ``python -m raft_stereo_tpu_torch.serve_stereo``
children run on the card in ``chip_smoke.py`` phase 9. The rollup is held
to the JAX package's ``obs/fleet.py`` on the same documents.
"""

from __future__ import annotations

import json
import os
import sys
import time
import urllib.request

import pytest

from raft_stereo_tpu.obs.fleet import rollup as jax_rollup

from raft_stereo_tpu_torch.obs.fleet import rollup
from raft_stereo_tpu_torch.serve.fleet import (FleetConfig, FleetFrontend, FleetSupervisor,
                                               InstanceSpec, default_command,
                                               resolve_fleet_instances, resolve_fleet_probe_ms,
                                               resolve_fleet_restart_budget,
                                               resolve_fleet_warmup_timeout_ms)

pytestmark = pytest.mark.fleet

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fleet_stub.py")


def stub_command(extra=None):
    extra = extra or (lambda spec: [])

    def cmd(spec):
        return [sys.executable, STUB, *extra(spec)]

    return cmd


def make_fleet(n=2, budget=3, extra=None, **cfg_kw):
    cfg_kw.setdefault("warmup_timeout_ms", 30_000.0)
    cfg_kw.setdefault("drain_grace_ms", 5_000.0)
    cfg = FleetConfig(instances=n, restart_budget=budget, probe_ms=0,
                      restart_backoff_s=0.01,
                      command=stub_command(extra), **cfg_kw)
    return FleetSupervisor(cfg)


def post(supervisor, body=b"{}", session=None):
    headers = {"Content-Type": "application/json"}
    if session is not None:
        headers["X-Raft-Session"] = session
    status, ctype, payload, _ = supervisor.forward(headers, body)
    return status, json.loads(payload)


# -- knob resolution -------------------------------------------------------

def test_knob_resolution_precedence(monkeypatch):
    monkeypatch.setenv("RAFT_FLEET_INSTANCES", "5")
    monkeypatch.setenv("RAFT_FLEET_RESTART_BUDGET", "7")
    monkeypatch.setenv("RAFT_FLEET_PROBE_MS", "123")
    monkeypatch.setenv("RAFT_FLEET_WARMUP_TIMEOUT_MS", "456")
    assert resolve_fleet_instances() == 5
    assert resolve_fleet_restart_budget() == 7
    assert resolve_fleet_probe_ms() == 123.0
    assert resolve_fleet_warmup_timeout_ms() == 456.0
    # explicit config beats env
    assert resolve_fleet_instances(3) == 3
    assert resolve_fleet_restart_budget(1) == 1
    # floor of one instance
    assert resolve_fleet_instances(0) == 1


def test_knob_parse_error_names_the_variable(monkeypatch):
    monkeypatch.setenv("RAFT_FLEET_RESTART_BUDGET", "many")
    with pytest.raises(ValueError, match="RAFT_FLEET_RESTART_BUDGET"):
        resolve_fleet_restart_budget()
    monkeypatch.setenv("RAFT_FLEET_PROBE_MS", "soon")
    with pytest.raises(ValueError, match="RAFT_FLEET_PROBE_MS"):
        resolve_fleet_probe_ms()


def test_default_command_shape():
    argv = default_command(InstanceSpec(slot=0, generation=1,
                                        args=("--max_batch", "4")))
    assert argv[0] == sys.executable
    assert argv[1:3] == ["-m", "raft_stereo_tpu_torch.serve_stereo"]
    assert argv[3:5] == ["--http_port", "0"]
    assert argv[-2:] == ["--max_batch", "4"]


# -- launch / handshake ----------------------------------------------------

def test_launch_handshake_and_status():
    sup = make_fleet(n=2)
    with sup:
        ports = {inst.port for inst in sup._slots}
        assert len(ports) == 2 and None not in ports
        sup.poke()
        doc = sup.status()
        assert doc["schema"] == 1
        assert doc["instances"] == 2
        assert doc["states"].get("ready") == 2
        assert doc["generation"] == 1
        assert doc["degraded_slots"] == 0
        assert doc["fingerprints"] == ["stub-fp"]
        assert doc["counters"]["instances_total"] == 2
        assert doc["counters"]["restarts_total"] == 0
        # each by_instance row carries its slot, health fields, and the
        # per-slot restart-budget ledger (the first launch of a
        # generation is free)
        for i, row in enumerate(doc["by_instance"]):
            assert row["state"] == "ready"
            assert "uptime_s" in row and "headroom_rps" in row
            assert row["slot"] == i
            assert row["restarts_spent"] == 0
            assert row["budget_remaining"] == 3
            # and where the instance listens and its process id
            assert row["port"] == sup._slots[i].port
            assert row["pid"] == sup._slots[i].proc.pid
        assert doc["restart_budget"] == 3
        assert doc["heal"]["enabled"] is True
        assert doc["heal"]["refill_ms"] > 0
        assert doc["heal"]["slot_relaunches_total"] == 0
    # stop() drained both cleanly (SIGTERM kills the stub fast)
    assert int(sup.registry.value("raft_fleet_draining_total")) == 2
    assert int(sup.registry.value(
        "raft_fleet_kill_escalations_total")) == 0


# -- routing ---------------------------------------------------------------

def test_routing_prefers_headroom():
    # slot 0 advertises 10x the headroom of slot 1
    extra = lambda spec: ["--headroom",  # noqa: E731
                          "100" if spec.slot == 0 else "10"]
    sup = make_fleet(n=2, extra=extra)
    with sup:
        sup.poke()  # populate the health docs the weights read
        for _ in range(4):
            status, doc = post(sup)
            assert status == 200 and doc["status"] == "ok"
        books = sup.books()
        big = sup._slots[0].uid
        small = sup._slots[1].uid
        assert books[big]["answered"] > books[small]["answered"]


def test_saturated_instance_backpressured():
    extra = lambda spec: (  # noqa: E731
        ["--saturation", "0.99", "--headroom", "1000"]
        if spec.slot == 0 else ["--saturation", "0.1"])
    sup = make_fleet(n=2, extra=extra)
    with sup:
        sup.poke()
        for _ in range(3):
            status, _doc = post(sup)
            assert status == 200
        books = sup.books()
        assert books[sup._slots[0].uid]["answered"] == 0
        assert books[sup._slots[1].uid]["answered"] == 3


def test_session_affinity_pins_one_instance():
    sup = make_fleet(n=2)
    with sup:
        sup.poke()
        for _ in range(5):
            status, _doc = post(sup, session="cam-7")
            assert status == 200
        books = sup.books()
        answered = sorted(b["answered"] for b in books.values())
        assert answered == [0, 5], books


def test_books_reconcile_with_instance_counters():
    sup = make_fleet(n=2)
    with sup:
        sup.poke()
        for i in range(6):
            status, _doc = post(sup, session=f"cam-{i % 3}")
            assert status == 200
        sup.poke()  # refresh health docs -> instance request counters
        books = sup.books()
        for inst in sup._slots:
            served = inst.last_doc["requests"].get("ok", 0)
            assert served == books[inst.uid]["answered"]
            assert books[inst.uid]["undelivered"] == 0


# -- preemption ------------------------------------------------------------

def test_kill9_fails_over_and_replaces():
    sup = make_fleet(n=2)
    with sup:
        sup.poke()
        status, _doc = post(sup, session="cam-1")
        assert status == 200
        pinned_uid = None
        for inst in sup._slots:
            if sup.books()[inst.uid]["answered"] == 1:
                pinned_uid = inst.uid
                victim = inst
        assert pinned_uid is not None
        victim.proc.kill()
        victim.proc.wait(timeout=10)
        # The pinned instance is gone: the SAME session's next frame is
        # handed off to the surviving instance, structured 200, counted.
        status, doc = post(sup, session="cam-1")
        assert status == 200 and doc["status"] == "ok"
        assert int(sup.registry.value("raft_fleet_reroutes_total")) >= 1
        # The probe pass replaces the dead slot (same budget pool).
        sup.poke()
        assert all(i is not None and i.state == "ready"
                   for i in sup._slots)
        assert int(sup.registry.value("raft_fleet_restarts_total")) == 1
        new_uids = {i.uid for i in sup._slots}
        assert pinned_uid not in new_uids


def test_sick_health_block_triggers_replacement():
    # The supervision surface: a 200 /healthz whose own supervision block says
    # the scheduler heartbeat died is UNHEALTHY — replaced on the next
    # probe pass, no socket failure needed.
    extra = lambda spec: ["--sick-after", "1"]  # noqa: E731
    sup = make_fleet(n=1, extra=extra)
    with sup:
        sup.poke()
        old_uid = sup._slots[0].uid
        status, _doc = post(sup)
        assert status == 200
        sup.poke()  # sees scheduler_died -> kill + replace
        assert sup._slots[0] is not None
        assert sup._slots[0].uid != old_uid
        assert sup._slots[0].state == "ready"
        assert int(sup.registry.value("raft_fleet_restarts_total")) == 1


def test_all_dead_is_structured_not_hung():
    sup = make_fleet(n=1)
    with sup:
        inst = sup._slots[0]
        inst.proc.kill()
        inst.proc.wait(timeout=10)
        status, doc = post(sup)
        assert status == 503
        assert doc["status"] == "rejected"
        assert doc["code"] == "no_healthy_instance"


# -- warmup-death restart budget (satellite) -------------------------------

def test_warmup_death_retries_within_budget(tmp_path):
    countdown = tmp_path / "die"
    countdown.write_text("2")  # die twice, then come up
    extra = lambda spec: ["--die-before-ready",  # noqa: E731
                          str(countdown)]
    sup = make_fleet(n=1, budget=3, extra=extra)
    with sup:
        assert sup._slots[0] is not None
        assert sup._slots[0].state == "ready"
        assert int(sup.registry.value("raft_fleet_restarts_total")) == 2
        assert int(sup.registry.value(
            "raft_fleet_instances_total")) == 3
        assert sup.status()["degraded_slots"] == 0


def test_warmup_death_budget_exhausted_degrades(tmp_path):
    countdown = tmp_path / "die"
    countdown.write_text("99")  # always dies during warmup
    extra = lambda spec: (  # noqa: E731
        ["--die-before-ready", str(countdown)] if spec.slot == 0
        else [])
    sup = make_fleet(n=2, budget=2, extra=extra)
    with sup:
        # Slot 0 degraded after 1 + budget attempts — NOT a crash loop;
        # slot 1 serves on.
        assert sup._slots[0] is None
        assert sup._slots[1] is not None
        assert int(sup.registry.value("raft_fleet_restarts_total")) == 2
        doc = sup.status()
        assert doc["degraded_slots"] == 1
        assert doc["states"].get("degraded") == 1
        # the degraded row pins its exhausted ledger on /fleet/healthz
        row0 = doc["by_instance"][0]
        assert row0["state"] == "degraded" and row0["slot"] == 0
        assert row0["uid"] is None
        assert row0["restarts_spent"] == 2
        assert row0["budget_remaining"] == 0
        assert doc["by_instance"][1]["budget_remaining"] == 2
        status, resp = post(sup)
        assert status == 200 and resp["status"] == "ok"


# -- drain escalation (satellite) ------------------------------------------

def test_drain_overrun_escalates_to_sigkill():
    extra = lambda spec: ["--ignore-term"]  # noqa: E731
    sup = make_fleet(n=1, extra=extra, drain_grace_ms=300.0)
    sup.start()
    inst = sup._slots[0]
    sup.stop()
    assert int(sup.registry.value(
        "raft_fleet_kill_escalations_total")) == 1
    assert int(sup.registry.value("raft_fleet_draining_total")) == 1
    assert not inst.alive


# -- rolling deploy --------------------------------------------------------

def test_rolling_deploy_shifts_fingerprint_and_drains_old():
    def extra(spec):
        return list(spec.args)

    sup = make_fleet(n=2, extra=extra,
                     instance_args=("--fingerprint", "fp-A"))
    with sup:
        sup.poke()
        assert sup.status()["fingerprints"] == ["fp-A"]
        old_uids = {i.uid for i in sup._slots}
        status, _doc = post(sup, session="cam-roll")
        assert status == 200
        report = sup.deploy(
            instance_args=("--fingerprint", "fp-B"))
        assert report["completed"] is True
        assert report["generation"] == 2
        assert all(s["rolled"] for s in report["slots"])
        assert {i.uid for i in sup._slots}.isdisjoint(old_uids)
        sup.poke()
        doc = sup.status()
        assert doc["fingerprints"] == ["fp-B"]
        assert doc["generation"] == 2
        # the pinned session survived the roll: handed off, served by
        # the new generation
        status, resp = post(sup, session="cam-roll")
        assert status == 200 and resp["fingerprint_id"] == "fp-B"
        assert int(sup.registry.value(
            "raft_fleet_draining_total")) == 2
        assert int(sup.registry.value(
            "raft_fleet_reroutes_total")) >= 1


def test_rolling_deploy_failure_keeps_old_generation(tmp_path):
    countdown = tmp_path / "die"
    countdown.write_text("0")

    def extra(spec):
        # generation 2 launches always die during warmup
        if spec.generation >= 2:
            return ["--die-before-ready", str(countdown)]
        return []

    sup = make_fleet(n=2, budget=1, extra=extra)
    with sup:
        sup.poke()
        old_uids = {i.uid for i in sup._slots}
        countdown.write_text("99")
        report = sup.deploy()
        assert report["completed"] is False
        assert report["slots"][0]["rolled"] is False
        # the old generation still serves — an aborted roll is not an
        # outage
        assert {i.uid for i in sup._slots} == old_uids
        status, doc = post(sup)
        assert status == 200 and doc["status"] == "ok"


# -- fleet ingress ---------------------------------------------------------

def test_fleet_frontend_end_to_end():
    sup = make_fleet(n=2)
    with sup:
        sup.poke()
        fe = FleetFrontend(sup).start()
        try:
            base = f"http://127.0.0.1:{fe.port}"
            req = urllib.request.Request(
                base + "/v1/stereo", data=b"{}", method="POST",
                headers={"Content-Type": "application/json",
                         "X-Raft-Session": "cam-fe"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 200
                doc = json.loads(resp.read())
            assert doc["status"] == "ok"
            assert doc["session"] == "cam-fe"
            with urllib.request.urlopen(base + "/fleet/healthz",
                                        timeout=30) as resp:
                health = json.loads(resp.read())
            assert health["instances"] == 2
            assert health["books"]
            assert sum(b["answered"]
                       for b in health["books"].values()) == 1
            with urllib.request.urlopen(base + "/fleet/metrics",
                                        timeout=30) as resp:
                text = resp.read().decode()
            assert "raft_fleet_instances_total" in text
            assert "raft_fleet_reroutes_total" in text
            # unknown routes are structured JSON, not stdlib HTML
            try:
                urllib.request.urlopen(base + "/nope", timeout=30)
                raised = None
            except urllib.error.HTTPError as e:
                raised = json.loads(e.read())
            assert raised and raised["code"] == "not_found"
        finally:
            fe.stop()


# -- rollup (obs/fleet.py) -------------------------------------------------

def test_rollup_aggregation_rules():
    rows = [
        {"uid": "a", "state": "ready", "doc": {
            "fingerprint_id": "f1", "uptime_s": 10.0,
            "requests": {"ok": 3, "rejected:queue_full": 1},
            "stream": {"sessions": 2}, "cache": {"entries": 5},
            "capacity": {"by_bucket": {"x": {"headroom_rps": 4.0}},
                         "saturation": {"ratio": 0.2}}}},
        {"uid": "b", "state": "ready", "doc": {
            "fingerprint_id": "f2", "uptime_s": 3.0,
            "requests": {"ok": 2},
            "stream": {"sessions": 1}, "cache": {"entries": 0},
            "capacity": {"by_bucket": {"x": {"headroom_rps": 1.5}},
                         "saturation": {"ratio": 0.9}}}},
        {"uid": None, "state": "degraded", "doc": None},
    ]
    doc = rollup(rows)
    assert doc == jax_rollup(rows)
    assert doc["instances"] == 3
    assert doc["states"] == {"ready": 2, "degraded": 1}
    assert doc["requests"] == {"ok": 5, "rejected:queue_full": 1}
    assert doc["fingerprints"] == ["f1", "f2"] and doc["rolling"]
    assert doc["headroom_rps"] == pytest.approx(5.5)
    assert doc["saturation"] == 0.9          # max, not mean
    assert doc["uptime_min_s"] == 3.0        # youngest bounds warmth
    assert doc["stream_sessions"] == 3
    assert doc["cache_entries"] == 5


def test_rollup_survives_truncated_docs():
    doc = rollup([{"uid": "a", "state": "ready",
                   "doc": {"requests": "garbage",
                           "capacity": {"by_bucket": None}}}])
    assert doc == jax_rollup([{"uid": "a", "state": "ready",
                               "doc": {"requests": "garbage",
                                       "capacity": {"by_bucket": None}}}])
    assert doc["instances"] == 1
    assert doc["requests"] == {}
    assert doc["headroom_rps"] is None


# -- restart budgets refill on the decay clock (tests/test_heal.py's fleet
# -- cases): a degraded slot re-enters probation ----------------------------


def test_fleet_budget_refill_probation(tmp_path):
    countdown = tmp_path / "die"
    countdown.write_text("99")        # every launch dies during warmup
    extra = lambda spec: ["--die-before-ready",  # noqa: E731
                          str(countdown)]
    sup = make_fleet(n=1, budget=1, extra=extra,
                     restart_refill_ms=600_000.0)
    with sup:
        # Budget exhausted during start: the slot degraded, and the
        # ledger is visible per-slot on /fleet/healthz.
        assert sup._slots[0] is None
        doc = sup.status()
        assert doc["degraded_slots"] == 1
        row = doc["by_instance"][0]
        assert row["state"] == "degraded" and row["slot"] == 0
        assert row["restarts_spent"] == 1
        assert row["budget_remaining"] == 0
        assert doc["heal"]["enabled"] is True
        assert doc["heal"]["slot_relaunches_total"] == 0
        # No refund yet: the probation pass must NOT relaunch.
        sup.poke()
        assert sup._slots[0] is None
        # The fault clears AND the decay clock refunds a charge: the
        # next poke runs exactly one handshake-verified relaunch.
        countdown.write_text("0")
        sup.refill_s = 0.05
        time.sleep(0.12)
        sup.poke()
        assert sup._slots[0] is not None
        assert sup._slots[0].state == "ready"
        doc = sup.status()
        assert doc["degraded_slots"] == 0
        assert doc["heal"]["slot_relaunches_total"] == 1


def test_fleet_refill_disabled_stays_degraded(tmp_path):
    countdown = tmp_path / "die"
    countdown.write_text("99")
    extra = lambda spec: ["--die-before-ready",  # noqa: E731
                          str(countdown)]
    # heal=False: even a ~0 refill interval must never relaunch — the
    # one-way semantics, bit for bit.
    sup = make_fleet(n=1, budget=1, extra=extra, heal=False,
                     restart_refill_ms=1.0)
    with sup:
        assert sup._slots[0] is None
        assert sup.status()["heal"]["enabled"] is False
        countdown.write_text("0")
        time.sleep(0.05)
        sup.poke()
        assert sup._slots[0] is None               # stays dark
        doc = sup.status()
        assert doc["degraded_slots"] == 1
        assert doc["heal"]["slot_relaunches_total"] == 0
        assert doc["by_instance"][0]["budget_remaining"] == 0
