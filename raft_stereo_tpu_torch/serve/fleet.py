"""The fleet supervisor: N ``serve_stereo`` processes behind one router.

The port's counterpart of the JAX package's ``serve/fleet.py``, with the
same API, knobs, metrics, health document and error codes. One process
survives a lot (the breaker ladder takes kernel failures, the watchdog
bounces hung generations, the stream table warm-starts video, the cache
spills to disk), but a ``kill -9`` still stops it, a config change still
means downtime, and nothing routes on health. This module owns N
``python -m raft_stereo_tpu_torch.serve_stereo`` instances as
subprocesses and turns them into one service:

- **launch & handshake** — each instance binds ``--http_port 0`` and
  prints the ``RAFT_HTTP_PORT=<n>`` readiness line once its warm-up
  captures finish; the supervisor reads it from the child's stdout (a
  reader thread per instance drains the pipe forever, so a chatty child
  never wedges on a full pipe);
- **health routing** — a probe loop GETs every instance's ``/healthz``;
  placement weight is the capacity block's summed ``headroom_rps``
  (theoretical rps x (1 - saturation), obs/capacity.py) and a saturated
  instance (ratio >= SATURATION_BACKPRESSURE) is skipped while any
  unsaturated peer exists. ``X-Raft-Session`` stream affinity pins a
  session to one instance (the held 1/8-res seed lives in THAT process's
  stream table) and re-pins it the moment its instance drains or dies;
- **replacement** — a dead process (``poll()``), a hung one (consecutive
  probe failures) or a sick one (scheduler heartbeat dead in its own
  health block) leaves rotation; its in-flight forwards fail STRUCTURED
  (bounded socket operations turn a lost connection into a JSON 502/503,
  never a hung client socket) and a replacement is launched into the
  same slot with the same ``RAFT_CACHE_DIR``, so the cache's disk spill
  carries the warm exact tier across the death;
- **rolling deploys** — ``deploy()`` bumps the generation, launches the
  new instance BESIDE the old one per slot, waits for its handshake,
  shifts routing (and hands off pinned sessions), then SIGTERM-drains the
  old under ``RAFT_DRAIN_GRACE_MS`` with a counted SIGKILL when the grace
  expires;
- **bounded self-healing** — every launch retry and death replacement
  spends one unit of the per-slot ``RAFT_FLEET_RESTART_BUDGET`` (reset
  each generation); an exhausted slot is reported DEGRADED in
  ``/fleet/healthz`` instead of crash-looping the fleet.

Host-side orchestration only: no program, fingerprint or cache key
changes. The fleet's metrics live in a private registry
(``raft_fleet_{instances,restarts,reroutes,draining}_total`` ...) at
``GET /fleet/metrics``; ``GET /fleet/healthz`` is the obs/fleet.py rollup
of the instances' own documents plus the router's books (the requests
forwarded to each instance, which reconcile with its
``raft_requests_total``).

Several instances on one card each capture their own CUDA graphs in their
own process; the capture gates (``serve/session.py:_CaptureGate``, one a
device) are per process, so two instances' captures may overlap on the
card.

Knobs (read at function scope; ``analysis/knobs.py`` HOST_ENV_KNOBS —
fleet topology, never in a fingerprint):

- ``RAFT_FLEET_INSTANCES``         — fleet width (default 2);
- ``RAFT_FLEET_RESTART_BUDGET``    — per-slot launch retries + death
  replacements per generation before the slot degrades (default 3);
- ``RAFT_FLEET_PROBE_MS``          — health-probe period (default
  500 ms; <= 0 disables the background prober — tests drive
  :meth:`FleetSupervisor.poke`);
- ``RAFT_FLEET_WARMUP_TIMEOUT_MS`` — readiness-handshake deadline per
  launch attempt (default 600 s: an instance captures every warm-up
  program before it is ready);
- ``RAFT_HEAL`` / ``RAFT_HEAL_REFILL_MS`` (serve/heal.py) — restart
  budgets REFILL on a decay clock (one charge refunded per refill
  interval), so a degraded slot re-enters probation — one budget-charged,
  probe-verified relaunch per refill — instead of staying dark until the
  next deploy. ``RAFT_HEAL=0`` restores the one-way per-generation
  budget exactly.

Testability: :class:`FleetConfig.command` injects the instance argv; the
CPU tests launch a stdlib stub (``tests/fleet_stub.py``) that speaks the
same handshake and health schema in milliseconds.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from raft_stereo_tpu_torch.obs.fleet import rollup
from raft_stereo_tpu_torch.obs.metrics import MetricsRegistry
from raft_stereo_tpu_torch.serve.heal import (resolve_heal_enabled,
                                        resolve_heal_refill_ms)
from raft_stereo_tpu_torch.serve.supervise import (_parse_number,
                                             resolve_drain_grace_ms)

logger = logging.getLogger(__name__)

DEFAULT_FLEET_INSTANCES = 2
DEFAULT_FLEET_RESTART_BUDGET = 3
DEFAULT_FLEET_PROBE_MS = 500.0
DEFAULT_FLEET_WARMUP_TIMEOUT_MS = 600_000.0

#: Consecutive /healthz probe failures before a live-but-unresponsive
#: process is declared hung and replaced (one blip — a GC pause, a probe
#: racing a bounce — must not cost a warm instance).
PROBE_FAIL_THRESHOLD = 3

#: Saturation ratio at which an instance stops taking NEW placements
#: while any less-saturated peer exists (backpressure, not ejection: a
#: busy instance is healthy, it is just full).
SATURATION_BACKPRESSURE = 0.98

#: Bound on the session-affinity table: LRU-evicted beyond this many
#: pinned sessions.  An evicted session is not broken — its next frame
#: re-pins (possibly elsewhere) and warm-joins there after one cold
#: frame; the bound exists because session ids are client-chosen bytes
#: (hostile-input discipline: no unbounded dict keyed by the wire).
AFFINITY_MAX = 4096

#: stdout lines kept per instance for the death report.
LINES_KEEP = 30


def resolve_fleet_instances(value: Optional[int] = None) -> int:
    """Fleet width: explicit config wins, else ``RAFT_FLEET_INSTANCES``,
    else 2.  Floor of 1 — a zero-instance fleet serves nothing and a
    misconfigured '0' should degrade to single-instance, not to outage."""
    if value is not None:
        return max(1, int(value))
    raw = os.environ.get("RAFT_FLEET_INSTANCES", "").strip()
    if not raw:
        return DEFAULT_FLEET_INSTANCES
    return max(1, _parse_number("RAFT_FLEET_INSTANCES", raw, int))


def resolve_fleet_restart_budget(value: Optional[int] = None) -> int:
    """Per-slot, per-generation launch/replacement budget: explicit
    config wins, else ``RAFT_FLEET_RESTART_BUDGET``, else 3."""
    if value is not None:
        return int(value)
    raw = os.environ.get("RAFT_FLEET_RESTART_BUDGET", "").strip()
    if not raw:
        return DEFAULT_FLEET_RESTART_BUDGET
    return _parse_number("RAFT_FLEET_RESTART_BUDGET", raw, int)


def resolve_fleet_probe_ms(value: Optional[float] = None) -> float:
    """Health-probe period in ms: explicit config wins, else
    ``RAFT_FLEET_PROBE_MS``, else 500.  <= 0 disables the background
    prober (deterministic tests drive ``poke()`` directly)."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_FLEET_PROBE_MS", "").strip()
    if not raw:
        return DEFAULT_FLEET_PROBE_MS
    return _parse_number("RAFT_FLEET_PROBE_MS", raw, float)


def resolve_fleet_warmup_timeout_ms(value: Optional[float] = None
                                    ) -> float:
    """Per-attempt readiness deadline in ms: explicit config wins, else
    ``RAFT_FLEET_WARMUP_TIMEOUT_MS``, else 600 s."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_FLEET_WARMUP_TIMEOUT_MS", "").strip()
    if not raw:
        return DEFAULT_FLEET_WARMUP_TIMEOUT_MS
    return _parse_number("RAFT_FLEET_WARMUP_TIMEOUT_MS", raw, float)


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    """What one launch attempt is asked to become."""
    slot: int
    generation: int
    args: Tuple[str, ...] = ()


#: The key of an instance's readiness line, ``RAFT_HTTP_PORT=<port>``
#: (``serve_stereo.HANDSHAKE_KEY``; the embedded frontend's port knob).
HANDSHAKE_KEY = "RAFT_HTTP_PORT"

#: The directory that holds the ``raft_stereo_tpu_torch`` package: put on
#: every instance's ``PYTHONPATH`` so ``-m`` finds it from any directory.
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_command(spec: InstanceSpec) -> List[str]:
    """The production argv: ``python -m raft_stereo_tpu_torch.serve_stereo
    --http_port 0`` + the fleet's pass-through args. Port 0
    (kernel-assigned) is mandatory — N instances on one host cannot share
    a configured port, and the handshake line reports whatever was
    bound."""
    return [sys.executable, "-m", "raft_stereo_tpu_torch.serve_stereo",
            "--http_port", "0", *spec.args]


@dataclasses.dataclass
class FleetConfig:
    """Fleet topology + per-instance launch recipe.

    ``None`` fields defer to their ``RAFT_FLEET_*`` knob at
    :class:`FleetSupervisor` construction (the resolve_* precedence:
    explicit config > env > default — same contract as supervise.py).
    """
    instances: Optional[int] = None
    restart_budget: Optional[int] = None
    probe_ms: Optional[float] = None
    warmup_timeout_ms: Optional[float] = None
    #: Old-generation / dead-instance drain grace; defers to the
    #: RAFT_DRAIN_GRACE_MS contract (supervise.resolve_drain_grace_ms).
    drain_grace_ms: Optional[float] = None
    #: Extra argv appended to every instance launch (model size, cache
    #: flags...).  Changing it via deploy() is the rolling-deploy input.
    instance_args: Tuple[str, ...] = ()
    #: Extra environment for instances (merged over os.environ).
    instance_env: Optional[Dict[str, str]] = None
    #: Shared RAFT_CACHE_DIR: set it and every instance (including
    #: replacements after a death) spills/restores the cache's exact tier
    #: from the same directory — the warm state that survives a kill -9.
    cache_dir: Optional[str] = None
    #: argv factory — tests inject a stub here.
    command: Callable[[InstanceSpec], List[str]] = default_command
    #: Per-forward socket deadline: the "never a hung client socket"
    #: bound.  Generous because a first-of-its-bucket request compiles
    #: inline on the instance.
    forward_timeout_s: float = 600.0
    #: Probe socket deadline (short: a healthy /healthz answers in ms).
    probe_timeout_s: float = 5.0
    #: Backoff base between launch retries (attempt k sleeps k * this).
    restart_backoff_s: float = 0.25
    #: Fleet ingress body cap (same hostile-input stance as http.py).
    body_max: int = 64 << 20
    #: recovery-plane master switch for THIS supervisor
    #: (None -> RAFT_HEAL -> on).  Off = per-generation budgets are
    #: one-way, degraded slots stay dark until the next deploy.
    heal: Optional[bool] = None
    #: restart-budget decay interval — one spent charge is
    #: refunded per interval on the fleet's monotonic clock
    #: (None -> RAFT_HEAL_REFILL_MS -> 60 s).  Tests inject tiny values
    #: here; the fleet has no FakeClock seam by design (its children
    #: are real processes on real time).
    restart_refill_ms: Optional[float] = None


class FleetInstance:
    """One owned subprocess: launch, handshake, probe, drain, books."""

    def __init__(self, spec: InstanceSpec, uid: str, argv: List[str],
                 env: Dict[str, str]):
        self.spec = spec
        self.uid = uid
        self.argv = argv
        self.env = env
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.state = "launching"  # -> ready -> draining -> dead
        self.ready = threading.Event()
        self.fail_streak = 0
        self.last_doc: Optional[Dict] = None
        self.routed = 0           # placement tie-break (least-routed)
        self.lines: deque = deque(maxlen=LINES_KEEP)
        self._reader: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def launch(self) -> None:
        self.proc = subprocess.Popen(
            self.argv, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=self.env,
            start_new_session=True)
        # Reads the child's stdout until the pipe dies with the
        # process: reap()/kill() end it by killing the child, and
        # joining a reader blocked on a live pipe would hang forever.
        # graftlint: disable=GC206 (reader ends when reap/kill closes the pipe)
        self._reader = threading.Thread(
            target=self._drain_stdout, name=f"fleet-stdout-{self.uid}",
            daemon=True)
        self._reader.start()

    def _drain_stdout(self) -> None:
        """Read the child's stdout FOREVER: the handshake line arms
        ``ready``; everything after is kept in a bounded ring for the
        death report.  Never returning the pipe to the kernel unread is
        the no-wedge invariant — a child that logs after ready must not
        block on a full pipe because its supervisor stopped listening."""
        assert self.proc is not None and self.proc.stdout is not None
        try:
            for line in self.proc.stdout:
                line = line.rstrip("\n")
                self.lines.append(line)
                if line.startswith(f"{HANDSHAKE_KEY}="):
                    try:
                        self.port = int(line.split("=", 1)[1])
                    except ValueError:
                        continue
                    self.ready.set()
        except (OSError, ValueError):
            pass  # pipe died with the process — poll() is the truth

    def wait_ready(self, timeout_s: float) -> bool:
        """Await the handshake; False on timeout OR child death (the
        died-during-warmup satellite case — poll() breaks the wait early
        so a crash costs one poll interval, not the full warmup grace)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            # deploy() reaches this wait while holding _deploy_lock on
            # purpose: warmup is part of the one-rollout-at-a-time
            # critical section, and _deploy_lock is never taken on the
            # serving path.
            # graftlint: disable=GC203 (warmup wait inside the one-deploy-at-a-time mutex)
            if self.ready.wait(timeout=0.05):
                self.state = "ready"
                return True
            if self.proc is not None and self.proc.poll() is not None:
                self.state = "dead"
                return False
        return False

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def endpoint(self) -> Optional[str]:
        if self.port is None:
            return None
        return f"127.0.0.1:{self.port}"

    # -- health ------------------------------------------------------------

    def probe(self, timeout_s: float) -> Tuple[bool, Optional[str]]:
        """One /healthz GET.  Returns (healthy, reason-if-not); stores
        the document (the routing weight + rollup input) on success.  A
        200 whose own supervision block says the scheduler heartbeat
        died is UNHEALTHY — the watchdog surface is part of the
        fleet's liveness truth, not just socket reachability."""
        if not self.alive:
            return False, "process dead"
        if self.port is None:
            return False, "no handshake"
        import http.client
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", self.port, timeout=timeout_s)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                body = resp.read()
            finally:
                conn.close()
        except OSError as e:
            return False, f"probe failed: {e}"
        if resp.status != 200:
            return False, f"healthz status {resp.status}"
        try:
            doc = json.loads(body)
        except ValueError:
            return False, "healthz not json"
        self.last_doc = doc
        hb = (doc.get("supervision") or {}).get("heartbeats") or {}
        if hb.get("scheduler_alive") is False or hb.get(
                "scheduler_died"):
            return False, "scheduler heartbeat dead"
        return True, None

    def weight(self) -> Optional[float]:
        """Placement weight: summed per-bucket ``headroom_rps`` from the
        last health document (None until capacity EMAs warm — the router
        treats unknown as average, not as zero, so a fresh instance is
        not starved out of ever warming)."""
        doc = self.last_doc or {}
        buckets = ((doc.get("capacity") or {}).get("by_bucket") or {})
        total, seen = 0.0, False
        for m in buckets.values():
            h = m.get("headroom_rps") if isinstance(m, dict) else None
            if h is not None:
                total += float(h)
                seen = True
        return total if seen else None

    def saturation(self) -> Optional[float]:
        doc = self.last_doc or {}
        sat = (doc.get("capacity") or {}).get("saturation") or {}
        return sat.get("ratio")

    def chips(self) -> Optional[int]:
        """this instance's live data-mesh width from its last
        health document (None = single-device or never probed).  The
        per-bucket headroom the router weighs by already reflects the
        whole mesh's throughput — this accessor exists so the fleet
        rollup and /fleet/healthz advertise N-chip capacity per slot."""
        doc = self.last_doc or {}
        chips = (doc.get("capacity") or {}).get("chips") or {}
        n = chips.get("n_data")
        return int(n) if n is not None else None

    # -- teardown ----------------------------------------------------------

    def begin_drain(self) -> None:
        self.state = "draining"
        if self.alive:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass

    def reap(self, grace_s: float) -> bool:
        """Wait out the drain grace; SIGKILL on overrun.  Returns True
        when the child exited within grace (clean drain)."""
        if self.proc is None:
            self.state = "dead"
            return True
        try:
            self.proc.wait(timeout=max(0.0, grace_s))
            clean = True
        except subprocess.TimeoutExpired:
            clean = False
            self.kill()
        self.state = "dead"
        return clean

    def kill(self) -> None:
        self.state = "dead"
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass
            try:
                # Reaping a killed child under _deploy_lock is the
                # rollout's own cleanup; the serving path never waits on
                # this lock.
                # graftlint: disable=GC203 (bounded reap inside the deploy mutex)
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass


def _structured(status: int, code: str, message: str,
                retry_after_s: Optional[float] = None) -> Tuple[
                    int, str, bytes, Dict[str, str]]:
    """A fleet-originated response in the wire error schema (same
    status/code/message JSON the instance ingress sends) — the client
    cannot tell proxy-level failures from instance-level ones by shape,
    only by code."""
    body = json.dumps({"status": "rejected" if status == 503 else "error",
                       "code": code, "message": message}).encode()
    headers = {}
    if retry_after_s is not None:
        headers["Retry-After"] = str(int(retry_after_s))
    return status, "application/json", body, headers


class FleetSupervisor:
    """Owns the instances, the routing table and the books."""

    def __init__(self, cfg: Optional[FleetConfig] = None):
        self.cfg = cfg or FleetConfig()
        self.n = resolve_fleet_instances(self.cfg.instances)
        self.restart_budget = resolve_fleet_restart_budget(
            self.cfg.restart_budget)
        self.probe_s = resolve_fleet_probe_ms(self.cfg.probe_ms) / 1e3
        self.warmup_timeout_s = resolve_fleet_warmup_timeout_ms(
            self.cfg.warmup_timeout_ms) / 1e3
        self.drain_grace_s = resolve_drain_grace_ms(
            self.cfg.drain_grace_ms) / 1e3
        self.registry = MetricsRegistry()
        self._c_instances = self.registry.counter(
            "raft_fleet_instances_total", "instance launches (every "
            "attempt, including warmup retries and replacements)")
        self._c_restarts = self.registry.counter(
            "raft_fleet_restarts_total",
            "replacement launches after an instance died or failed "
            "warmup (first launches are not restarts)")
        self._c_reroutes = self.registry.counter(
            "raft_fleet_reroutes_total",
            "requests and pinned sessions moved off a dead/draining "
            "instance")
        self._c_draining = self.registry.counter(
            "raft_fleet_draining_total", "instances SIGTERM-drained")
        self._c_kills = self.registry.counter(
            "raft_fleet_kill_escalations_total",
            "drains that exceeded the grace and were SIGKILLed")
        self._c_heal_relaunch = self.registry.counter(
            "raft_heal_slot_relaunches_total",
            "degraded-slot probation relaunches after a restart-budget "
            "refill")
        self._g_generation = self.registry.gauge(
            "raft_fleet_generation", "current deploy generation")
        self._g_ready = self.registry.gauge(
            "raft_fleet_ready", "instances currently in rotation")
        self._lock = threading.RLock()
        self._slots: List[Optional[FleetInstance]] = [None] * self.n
        self._retired: List[FleetInstance] = []
        self._affinity: "OrderedDict[str, str]" = OrderedDict()
        self._books: Dict[str, Dict] = {}
        self._spent: Dict[int, int] = {}   # slot -> budget used this gen
        # restart-budget decay.  _refill_last[slot] is the
        # monotonic instant up to which refunds were accounted — armed
        # at a slot's first charge, advanced in whole refill intervals.
        self.heal_enabled = resolve_heal_enabled(self.cfg.heal)
        self.refill_s = resolve_heal_refill_ms(
            self.cfg.restart_refill_ms) / 1e3
        self._refill_last: Dict[int, float] = {}
        self._generation = 0
        self._uid_seq = 0
        self._args = tuple(self.cfg.instance_args)
        self._env = dict(self.cfg.instance_env or {})
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._deploy_lock = threading.Lock()
        self._started = time.monotonic()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        with self._lock:
            self._generation = 1
        self._g_generation.set(1.0)
        for slot in range(self.n):
            inst = self._launch_slot(slot, self._generation)
            with self._lock:
                self._slots[slot] = inst
        self._publish_ready()
        if self.probe_s > 0:
            self._prober = threading.Thread(
                target=self._probe_loop, name="fleet-prober", daemon=True)
            self._prober.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=10)
        with self._lock:
            insts = [i for i in self._slots if i is not None]
            self._slots = [None] * self.n
        for inst in insts:
            inst.begin_drain()
            self._c_draining.inc()
        for inst in insts:
            if not inst.reap(self.drain_grace_s):
                self._c_kills.inc()
        with self._lock:
            retired, self._retired = self._retired, []
        for inst in retired:
            inst.kill()
        self._publish_ready()

    def __enter__(self) -> "FleetSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- launch ------------------------------------------------------------

    def _instance_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        path = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (_PACKAGE_PARENT if not path
                             else os.pathsep.join((_PACKAGE_PARENT, path)))
        env.update(self._env)
        if self.cfg.cache_dir is not None:
            env["RAFT_CACHE_DIR"] = self.cfg.cache_dir
        return env

    def _effective_spent_locked(self, slot: int) -> int:
        """The slot's spent budget AFTER decay refunds.
        Caller holds ``self._lock``.  With healing off (or a
        non-positive refill) this is exactly the raw per-generation
        counter — the one-way semantics.  Refunds are accounted
        in whole refill intervals on the fleet's monotonic clock and
        folded back into ``_spent``, so every reader (charging,
        relaunch eligibility, /fleet/healthz) sees one truth."""
        with self._lock:  # re-entrant: callers already hold it
            spent = self._spent.get(slot, 0)
            if not self.heal_enabled or self.refill_s <= 0:
                return spent
            last = self._refill_last.get(slot)
            if last is None:
                return spent
            now = time.monotonic()
            refunds = int((now - last) / self.refill_s)
            if refunds > 0:
                self._refill_last[slot] = last + refunds * self.refill_s
                if spent > 0:
                    spent = max(0, spent - refunds)
                    self._spent[slot] = spent
            return spent

    def _launch_slot(self, slot: int, generation: int,
                     replacement: bool = False
                     ) -> Optional[FleetInstance]:
        """Launch one slot to readiness under the slot's remaining
        budget.  Every warmup retry — and, with ``replacement=True``,
        the relaunch after an in-service death — consumes one unit of
        the slot's per-generation budget and counts a restart; an
        exhausted budget returns None (the DEGRADED slot — the fleet
        serves on, smaller) instead of crash-looping."""
        spec = InstanceSpec(slot=slot, generation=generation,
                            args=self._args)
        first = True
        while not self._stop.is_set():
            spent = 0
            if not first or replacement:
                with self._lock:
                    spent = self._effective_spent_locked(slot)
                    if spent < self.restart_budget:
                        self._spent[slot] = spent + 1
                        # Arm the decay clock at the first live charge.
                        self._refill_last.setdefault(
                            slot, time.monotonic())
                if spent >= self.restart_budget:
                    logger.warning(
                        "fleet slot %d: restart budget (%d) exhausted in "
                        "generation %d — slot degraded", slot,
                        self.restart_budget, generation)
                    return None
                self._c_restarts.inc()
            if not first:
                # Linear backoff, attempt-scaled: enough to let a
                # transient (port exhaustion, OOM reclaim) clear, short
                # enough that tests with a ~0 base stay fast.
                # deploy() holds _deploy_lock across the whole rollout
                # BY DESIGN — one deploy at a time; backoff inside it
                # only delays that deploy, and the serving plane's
                # _lock is NOT held across this sleep.
                # graftlint: disable=GC203 (backoff under the one-deploy-at-a-time mutex only)
                time.sleep(self.cfg.restart_backoff_s * (spent + 1))
            first = False
            with self._lock:
                self._uid_seq += 1
                uid = f"i{slot}-g{generation}-{self._uid_seq}"
            inst = FleetInstance(spec, uid, list(self.cfg.command(spec)),
                                 self._instance_env())
            try:
                inst.launch()
            except OSError as e:
                logger.warning("fleet slot %d: launch failed: %s",
                               slot, e)
                continue
            self._c_instances.inc()
            with self._lock:
                self._books[uid] = {"sent": 0, "answered": 0,
                                    "undelivered": 0, "by_status": {}}
            if inst.wait_ready(self.warmup_timeout_s):
                logger.info("fleet slot %d: %s ready on port %s",
                            slot, uid, inst.port)
                return inst
            # Died during warmup or never handshook within the grace:
            # make sure it is gone, then retry under the budget.
            inst.kill()
            logger.warning(
                "fleet slot %d: %s failed warmup (%s); last output: %s",
                slot, uid,
                "died" if not inst.alive else "handshake timeout",
                list(inst.lines)[-3:])
        return None

    # -- probing / self-healing --------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_s):
            try:
                self.poke()
            except Exception:
                logger.exception("fleet probe pass failed")

    def poke(self) -> None:
        """One synchronous probe pass over every slot — the prober
        thread's body, exposed so tests can drive
        detection deterministically."""
        with self._lock:
            live = [(slot, inst) for slot, inst in enumerate(self._slots)
                    if inst is not None]
        for slot, inst in live:
            if inst.state != "ready":
                continue
            healthy, reason = inst.probe(self.cfg.probe_timeout_s)
            if healthy:
                inst.fail_streak = 0
                continue
            inst.fail_streak += 1
            process_gone = not inst.alive
            if not process_gone and \
                    inst.fail_streak < PROBE_FAIL_THRESHOLD and \
                    reason != "scheduler heartbeat dead":
                continue
            logger.warning("fleet slot %d: %s unhealthy (%s, streak "
                           "%d) — replacing", slot, inst.uid, reason,
                           inst.fail_streak)
            inst.kill()
            self._unpin_all(inst.uid)
            replacement = self._launch_slot(slot, self._generation,
                                            replacement=True)
            with self._lock:
                if self._slots[slot] is inst:
                    self._slots[slot] = replacement
            self._publish_ready()
        # degraded-slot probation.  A slot that exhausted its
        # budget went dark (None); once the decay clock has refunded a
        # charge, it gets ONE budget-charged, handshake-verified
        # relaunch — naturally paced at one attempt per refill interval
        # because the attempt re-spends the refunded charge.  The
        # silent pre-check keeps an exhausted slot from logging a
        # budget warning on every probe pass.
        if self.heal_enabled and not self._stop.is_set():
            with self._lock:
                gen = self._generation
                degraded = [
                    slot for slot, inst in enumerate(self._slots)
                    if inst is None
                    and self._effective_spent_locked(slot)
                    < self.restart_budget]
            for slot in degraded:
                inst = self._launch_slot(slot, gen, replacement=True)
                if inst is None:
                    continue
                adopted = False
                with self._lock:
                    if self._slots[slot] is None:
                        self._slots[slot] = inst
                        adopted = True
                if not adopted:
                    # A concurrent deploy() re-filled the slot while we
                    # were warming our probe instance — ours loses.
                    inst.kill()
                    continue
                self._c_heal_relaunch.inc()
                logger.warning(
                    "fleet slot %d: degraded slot re-entered service "
                    "as %s after a restart-budget refill", slot,
                    inst.uid)
        self._publish_ready()

    def _publish_ready(self) -> None:
        with self._lock:
            ready = sum(1 for i in self._slots
                        if i is not None and i.state == "ready")
        self._g_ready.set(float(ready))

    # -- routing -----------------------------------------------------------

    def _routable(self, exclude: Tuple[str, ...] = ()
                  ) -> List[FleetInstance]:
        with self._lock:
            return [i for i in self._slots
                    if i is not None and i.state == "ready" and i.alive
                    and i.uid not in exclude]

    def _pick(self, exclude: Tuple[str, ...] = ()
              ) -> Optional[FleetInstance]:
        """Headroom-weighted placement: among routable instances, prefer
        unsaturated ones, then the highest headroom; unknown headroom
        (capacity EMAs not warmed) ranks as the average of the known
        ones so fresh instances still take traffic.  Ties break to the
        least-routed (deterministic round-robin, no RNG)."""
        candidates = self._routable(exclude)
        if not candidates:
            return None
        unsaturated = [i for i in candidates
                       if (i.saturation() or 0.0) <
                       SATURATION_BACKPRESSURE]
        pool = unsaturated or candidates
        known = [w for w in (i.weight() for i in pool) if w is not None]
        fallback = (sum(known) / len(known)) if known else 1.0

        def rank(inst: FleetInstance) -> Tuple[float, int]:
            w = inst.weight()
            return (-(w if w is not None else fallback), inst.routed)

        return min(pool, key=rank)

    def _session_key(self, raw: Optional[str]) -> Optional[str]:
        if not raw:
            return None
        return raw[:128]

    def _unpin_all(self, uid: str) -> None:
        """Hand off every session pinned to a retiring/dead instance:
        eagerly re-pin to a routable peer (counted as reroutes).  The
        next frame runs cold THERE and the stream warm-joins from then
        on — the session survives, the seed is rebuilt (the held
        1/8-res flow died with the old process's stream table)."""
        with self._lock:
            moving = [s for s, u in self._affinity.items() if u == uid]
        for sess in moving:
            target = self._pick(exclude=(uid,))
            with self._lock:
                if target is None:
                    self._affinity.pop(sess, None)
                else:
                    self._affinity[sess] = target.uid
            self._c_reroutes.inc()

    def _route(self, session: Optional[str],
               exclude: Tuple[str, ...] = ()) -> Optional[FleetInstance]:
        sess = self._session_key(session)
        if sess is not None:
            with self._lock:
                pinned = self._affinity.get(sess)
            if pinned is not None and pinned not in exclude:
                for inst in self._routable():
                    if inst.uid == pinned:
                        return inst
                # Pinned instance left rotation between frames: fall
                # through to a fresh pick and count the handoff.
                self._c_reroutes.inc()
        inst = self._pick(exclude)
        if inst is not None and sess is not None:
            with self._lock:
                self._affinity[sess] = inst.uid
                self._affinity.move_to_end(sess)
                while len(self._affinity) > AFFINITY_MAX:
                    self._affinity.popitem(last=False)
        return inst

    # -- forwarding --------------------------------------------------------

    def forward(self, headers: Dict[str, str], body: bytes
                ) -> Tuple[int, str, bytes, Dict[str, str]]:
        """Proxy one POST /v1/stereo.  Connection loss mid-exchange is
        counted against the instance's books as ``undelivered`` and the
        request is retried ONCE on a different instance (stereo
        inference is pure — a duplicate execution is wasted flops, not
        corruption); with no peers left the client gets a structured
        503/502, never a dangling socket."""
        import http.client
        session = headers.get("X-Raft-Session")
        tried: Tuple[str, ...] = ()
        for _attempt in range(2):
            inst = self._route(session, exclude=tried)
            if inst is None:
                return _structured(
                    503, "no_healthy_instance",
                    "no fleet instance is in rotation",
                    retry_after_s=1.0)
            with self._lock:
                book = self._books[inst.uid]
                book["sent"] += 1
                inst.routed += 1
            fwd_headers = {
                k: v for k, v in headers.items()
                if k.lower() == "content-type" or
                k.lower().startswith("x-raft-")}
            try:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", inst.port,
                    timeout=self.cfg.forward_timeout_s)
                try:
                    conn.request("POST", "/v1/stereo", body=body,
                                 headers=fwd_headers)
                    resp = conn.getresponse()
                    payload = resp.read()
                    status = resp.status
                    ctype = resp.getheader("Content-Type",
                                           "application/json")
                    extra = {}
                    retry_after = resp.getheader("Retry-After")
                    if retry_after:
                        extra["Retry-After"] = retry_after
                finally:
                    conn.close()
            except OSError:
                # The instance vanished mid-exchange (the kill -9 case).
                with self._lock:
                    book["undelivered"] += 1
                self._c_reroutes.inc()
                tried = tried + (inst.uid,)
                continue
            with self._lock:
                book["answered"] += 1
                key = str(status)
                book["by_status"][key] = book["by_status"].get(key, 0) + 1
            return status, ctype, payload, extra
        return _structured(
            502, "instance_lost",
            "the serving instance was lost mid-request and its peer "
            "retry also failed; safe to retry", retry_after_s=1.0)

    # -- rolling deploy ----------------------------------------------------

    def deploy(self, instance_args: Optional[Sequence[str]] = None,
               instance_env: Optional[Dict[str, str]] = None) -> Dict:
        """Zero-downtime roll to a new instance recipe.

        Per slot, strictly: launch the NEW generation beside the old,
        await its warmup handshake, shift routing (hand off pinned
        sessions), SIGTERM-drain the old under the grace (SIGKILL
        escalation counted).  A slot whose new instance cannot reach
        readiness within the (fresh) budget KEEPS its old instance and
        aborts the remainder of the roll — half a fleet on the new
        fingerprint and half on the old is recoverable (deploy again);
        half a fleet dead is an outage."""
        with self._deploy_lock:
            with self._lock:
                if instance_args is not None:
                    self._args = tuple(instance_args)
                if instance_env is not None:
                    self._env = dict(instance_env)
                self._generation += 1
                gen = self._generation
                self._spent = {}   # fresh budget per generation
                self._refill_last = {}  # fresh decay clock too
            self._g_generation.set(float(gen))
            report: Dict = {"generation": gen, "slots": [],
                            "completed": True}
            for slot in range(self.n):
                with self._lock:
                    old = self._slots[slot]
                new = self._launch_slot(slot, gen)
                if new is None:
                    report["slots"].append(
                        {"slot": slot, "rolled": False,
                         "kept": old.uid if old is not None else None})
                    report["completed"] = False
                    break
                with self._lock:
                    self._slots[slot] = new
                self._publish_ready()
                report["slots"].append({"slot": slot, "rolled": True,
                                        "new": new.uid,
                                        "old": (old.uid if old is not None
                                                else None)})
                if old is not None:
                    self._retire(old)
            return report

    def _retire(self, inst: FleetInstance) -> None:
        """Take one instance out of rotation and drain it in the
        background: routing shifted first (sessions handed off), THEN
        SIGTERM — in-flight requests it already accepted run to their
        segment-boundary exits inside the drain grace."""
        inst.begin_drain()
        self._c_draining.inc()
        self._unpin_all(inst.uid)
        with self._lock:
            self._retired.append(inst)

        def _reap() -> None:
            if not inst.reap(self.drain_grace_s):
                self._c_kills.inc()
            with self._lock:
                if inst in self._retired:
                    self._retired.remove(inst)

        # Bounded fire-and-forget: _reap ends within drain_grace_s by
        # construction — reap() escalates to SIGKILL at the deadline —
        # and stop()'s sweep re-reaps anything still in _retired, so no
        # reap thread outlives the supervisor.
        # graftlint: disable=GC206 (bounded by drain_grace_s; stop() re-reaps _retired)
        threading.Thread(target=_reap, name=f"fleet-reap-{inst.uid}",
                         daemon=True).start()

    # -- status ------------------------------------------------------------

    def books(self) -> Dict[str, Dict]:
        """The router's per-instance ledger (by instance uid): requests
        sent, answered (a complete HTTP response was read back — the
        count that must reconcile with the instance's own
        ``raft_requests_total``), undelivered (connection lost
        mid-exchange), and the answered-by-HTTP-status split."""
        with self._lock:
            return {uid: {"sent": b["sent"], "answered": b["answered"],
                          "undelivered": b["undelivered"],
                          "by_status": dict(b["by_status"])}
                    for uid, b in self._books.items()}

    def status(self) -> Dict:
        """The GET /fleet/healthz document: supervisor state + the
        obs/fleet.py rollup of every instance's own last health doc +
        the router's books."""
        with self._lock:
            rows = []
            degraded = 0
            for slot, inst in enumerate(self._slots):
                # every slot row carries its live
                # budget position — decay refunds included — so an
                # operator watching /fleet/healthz sees a degraded
                # slot's budget_remaining climb back above zero before
                # its probation relaunch fires.
                spent = self._effective_spent_locked(slot)
                budget = {"restarts_spent": spent,
                          "budget_remaining": max(
                              0, self.restart_budget - spent)}
                if inst is None:
                    degraded += 1
                    rows.append({"uid": None, "slot": slot,
                                 "state": "degraded", "doc": None,
                                 **budget})
                    continue
                rows.append({"uid": inst.uid, "slot": slot,
                             "state": inst.state, "doc": inst.last_doc,
                             "chips": inst.chips(), "port": inst.port,
                             "pid": (inst.proc.pid if inst.proc is not None
                                     else None), **budget})
            draining = len(self._retired)
            affinity = len(self._affinity)
        doc = rollup(rows)
        # advertise the pod's summed chip count as a gauge so
        # an operator scraping /fleet/metrics sees capacity shrink when
        # an instance quarantines a chip.
        if doc.get("chips") is not None:
            self.registry.gauge(
                "raft_fleet_chips",
                "data-mesh chips advertised across the fleet"
            ).set(doc["chips"])
        doc.update({
            "generation": self._generation,
            "restart_budget": self.restart_budget,
            "heal": {
                "enabled": self.heal_enabled,
                "refill_ms": self.refill_s * 1e3,
                "slot_relaunches_total": int(self.registry.value(
                    "raft_heal_slot_relaunches_total")),
            },
            "degraded_slots": degraded,
            "draining": draining,
            "pinned_sessions": affinity,
            "uptime_s": time.monotonic() - self._started,
            "books": self.books(),
            "counters": {
                "instances_total": int(self.registry.value(
                    "raft_fleet_instances_total")),
                "restarts_total": int(self.registry.value(
                    "raft_fleet_restarts_total")),
                "reroutes_total": int(self.registry.value(
                    "raft_fleet_reroutes_total")),
                "draining_total": int(self.registry.value(
                    "raft_fleet_draining_total")),
                "kill_escalations_total": int(self.registry.value(
                    "raft_fleet_kill_escalations_total")),
            },
        })
        for row, slot_doc in zip(doc["by_instance"], rows):
            row["slot"] = slot_doc["slot"]
            # Where the instance listens and its process id (None for a
            # degraded slot): what an operator needs to reach or signal
            # one instance directly.
            row["port"] = slot_doc.get("port")
            row["pid"] = slot_doc.get("pid")
            row["restarts_spent"] = slot_doc["restarts_spent"]
            row["budget_remaining"] = slot_doc["budget_remaining"]
        return doc

    def metrics_text(self) -> str:
        return self.registry.render_prometheus()


# -- fleet ingress ---------------------------------------------------------

class _FleetHandler(BaseHTTPRequestHandler):
    """The fleet's thin wire surface: forward POST /v1/stereo, answer
    the two fleet-plane GETs.  Deliberately much smaller than the
    instance ingress (serve/http.py) — multipart parsing, decode
    offload, quotas and per-tenant accounting all happen ON the
    instance; the fleet only moves bytes and owns placement.  What it
    does share is the structured-error stance: every failure path
    writes a JSON body with a stable code."""

    supervisor: "FleetSupervisor" = None  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"
    #: Per-read socket timeout (BaseHTTPRequestHandler honors this via
    #: the connection's settimeout) — a client trickling its request
    #: line cannot pin a handler thread forever.
    timeout = 30.0

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        logger.debug("fleet-http %s — " + fmt,
                     self.client_address[0], *args)

    def _send(self, status: int, ctype: str, body: bytes,
              extra: Optional[Dict[str, str]] = None) -> None:
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionError, OSError):
            self.close_connection = True

    def _send_structured(self, status: int, code: str,
                         message: str) -> None:
        s, ctype, body, extra = _structured(status, code, message)
        self._send(s, ctype, body, extra)

    def send_error(self, code, message=None, explain=None):
        # http.server's own parse failures route here: keep them JSON.
        self._send_structured(int(code), f"http_{int(code)}",
                              message or "request rejected")
        self.close_connection = True

    def do_GET(self):  # noqa: N802 — stdlib handler naming
        path = self.path.split("?", 1)[0]
        if path in ("/fleet/healthz", "/healthz"):
            body = json.dumps(self.supervisor.status(),
                              default=str).encode()
            return self._send(200, "application/json", body)
        if path == "/fleet/metrics":
            return self._send(200, "text/plain; version=0.0.4",
                              self.supervisor.metrics_text().encode())
        self._send_structured(404, "not_found",
                              f"no fleet route {path!r}")

    def do_POST(self):  # noqa: N802 — stdlib handler naming
        path = self.path.split("?", 1)[0]
        if path != "/v1/stereo":
            return self._send_structured(404, "not_found",
                                         f"no fleet route {path!r}")
        try:
            length = int(self.headers.get("Content-Length", ""))
        except ValueError:
            return self._send_structured(
                411, "length_required",
                "POST /v1/stereo requires Content-Length")
        if length > self.supervisor.cfg.body_max:
            return self._send_structured(
                413, "body_too_large",
                f"body {length} bytes exceeds the fleet cap "
                f"{self.supervisor.cfg.body_max}")
        try:
            body = self.rfile.read(length)
        except (OSError, ConnectionError):
            self.close_connection = True
            return
        if len(body) != length:
            self.close_connection = True
            return self._send_structured(
                400, "truncated_body",
                "connection closed before Content-Length bytes arrived")
        status, ctype, payload, extra = self.supervisor.forward(
            {k: v for k, v in self.headers.items()}, body)
        self._send(status, ctype, payload, extra)


class _FleetServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class FleetFrontend:
    """The fleet's listening socket.  Construction binds (port 0 is
    final before :meth:`start`), so a supervisor-of-supervisors could
    apply the same handshake discipline one level up."""

    def __init__(self, supervisor: FleetSupervisor,
                 host: str = "127.0.0.1", port: int = 0):
        self.supervisor = supervisor
        handler = type("BoundFleetHandler", (_FleetHandler,),
                       {"supervisor": supervisor})
        self._server = _FleetServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def host(self) -> str:
        return self._server.server_address[0]

    def start(self) -> "FleetFrontend":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                kwargs={"poll_interval": 0.05},
                name="fleet-http-listener", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "FleetFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
