"""Fleet CLI of the port: ``python -m raft_stereo_tpu_torch.fleet_stereo``.

N supervised ``python -m raft_stereo_tpu_torch.serve_stereo`` instances
behind one router, with the root ``fleet_stereo.py``'s flags:

    # two instances on one card, a shared warm-state directory
    python -m raft_stereo_tpu_torch.fleet_stereo --instances 2 --fleet_port 8080 \\
        --cache_dir /var/tmp/raft-cache -- \\
        --restore_ckpt raftstereo.pth --max_batch 1 --warmup 375x1242

Everything after ``--`` is passed verbatim to every instance's launch (the
per-instance model and serving recipe); the flags before it shape the
FLEET. Each instance binds ``--http_port 0`` and hands its port back
through the ``RAFT_HTTP_PORT=<n>`` stdout handshake; clients talk only to
the fleet port:

    POST /v1/stereo      — routed to the healthiest instance
                           (headroom-weighted; X-Raft-Session pinned)
    GET  /fleet/healthz  — aggregated fleet health + the router's books
    GET  /fleet/metrics  — raft_fleet_* counters (Prometheus text)

Operations:

- SIGHUP triggers a rolling deploy (relaunch every slot on the current
  recipe — the upgrade path after swapping a checkpoint file or env);
- SIGTERM/SIGINT drains every instance under RAFT_DRAIN_GRACE_MS and
  exits 0 (second signal: default disposition, immediate);
- a killed, crashed or hung instance is replaced automatically under
  RAFT_FLEET_RESTART_BUDGET per slot.

Event lines on stdout are single JSON objects; the ``fleet_listening``
event carries the bound ``port`` and ``endpoint`` (the readiness
handshake of this CLI). ``--mesh_data`` is forwarded to the instances:
each serves one session over a data mesh of that many devices.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="fleet supervisor for serve_stereo instances",
        epilog="arguments after -- are passed to every instance's "
               "python -m raft_stereo_tpu_torch.serve_stereo")
    parser.add_argument("--instances", type=int, default=None,
                        help="fleet width (default RAFT_FLEET_INSTANCES or 2)")
    parser.add_argument("--fleet_port", type=int, default=0,
                        help="fleet ingress port (default 0 = ephemeral, "
                        "reported in the fleet_listening event)")
    parser.add_argument("--fleet_host", default="127.0.0.1",
                        help="fleet ingress bind address (default loopback; "
                        "widen to 0.0.0.0 deliberately)")
    parser.add_argument("--cache_dir", default=None,
                        help="shared RAFT_CACHE_DIR handed to every instance "
                        "(incl. replacements) so the disk-spilled exact tier "
                        "survives instance deaths")
    parser.add_argument("--restart_budget", type=int, default=None,
                        help="per-slot launch retries + replacements per "
                        "generation (default RAFT_FLEET_RESTART_BUDGET or 3)")
    parser.add_argument("--probe_ms", type=float, default=None,
                        help="health-probe period, ms (default "
                        "RAFT_FLEET_PROBE_MS or 500)")
    parser.add_argument("--warmup_timeout_ms", type=float, default=None,
                        help="per-launch readiness deadline, ms (default "
                        "RAFT_FLEET_WARMUP_TIMEOUT_MS or 600 s)")
    parser.add_argument("--drain_grace_ms", type=float, default=None,
                        help="SIGTERM drain grace per retiring instance "
                        "(default RAFT_DRAIN_GRACE_MS or 10 s; overrun "
                        "escalates to SIGKILL, counted)")
    # Restart budgets refill on a decay clock, so a degraded slot re-enters
    # probation (one handshake-verified relaunch per refill) instead of
    # staying dark until the next deploy.
    parser.add_argument("--restart_refill_ms", type=float, default=None,
                        help="restart-budget decay: one spent charge refunds "
                        "per this interval (default RAFT_HEAL_REFILL_MS or 60 s)")
    parser.add_argument("--no_heal", action="store_true",
                        help="disable the recovery plane (RAFT_HEAL=0 "
                        "equivalent): exhausted slots stay degraded until the "
                        "next deploy")
    parser.add_argument("--mesh_data", type=int, default=None,
                        help="per-instance data-mesh width, forwarded to every "
                        "instance: each drives one session over this many "
                        "devices")
    return parser


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        fleet_argv, instance_args = argv[:split], argv[split + 1:]
    else:
        fleet_argv, instance_args = argv, []
    args = build_parser().parse_args(fleet_argv)
    if args.mesh_data is not None:
        instance_args = instance_args + ["--mesh_data", str(args.mesh_data)]

    from raft_stereo_tpu_torch.serve.fleet import (FleetConfig, FleetFrontend,
                                                   FleetSupervisor)

    supervisor = FleetSupervisor(FleetConfig(
        instances=args.instances,
        restart_budget=args.restart_budget,
        probe_ms=args.probe_ms,
        warmup_timeout_ms=args.warmup_timeout_ms,
        drain_grace_ms=args.drain_grace_ms,
        heal=False if args.no_heal else None,
        restart_refill_ms=args.restart_refill_ms,
        cache_dir=args.cache_dir,
        instance_args=tuple(instance_args)))

    stop_requested = threading.Event()
    roll_requested = threading.Event()

    def _request_stop(signum, frame):  # noqa: ARG001 — signal signature
        if stop_requested.is_set():
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        stop_requested.set()

    def _request_roll(signum, frame):  # noqa: ARG001 — signal signature
        roll_requested.set()

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _request_stop)
        except ValueError:
            pass
    try:
        signal.signal(signal.SIGHUP, _request_roll)
    except (ValueError, AttributeError):
        pass

    print(json.dumps({"event": "fleet_starting", "instances": supervisor.n,
                      "instance_args": instance_args}), flush=True)
    supervisor.start()
    frontend = FleetFrontend(supervisor, host=args.fleet_host,
                             port=args.fleet_port).start()
    try:
        print(json.dumps({
            "event": "fleet_listening",
            "port": frontend.port,
            "endpoint": f"http://{frontend.host}:{frontend.port}",
            "routes": ["POST /v1/stereo", "GET /fleet/healthz", "GET /fleet/metrics"],
            "ready": int(supervisor.registry.value("raft_fleet_ready")),
        }), flush=True)
        while not stop_requested.wait(0.2):
            if roll_requested.is_set():
                roll_requested.clear()
                print(json.dumps({"event": "rolling_deploy", "reason": "SIGHUP"}),
                      flush=True)
                report = supervisor.deploy()
                print(json.dumps({"event": "rolled", **report}), flush=True)
        print(json.dumps({"event": "fleet_draining", "reason": "signal received"}),
              flush=True)
    finally:
        frontend.stop()
        supervisor.stop()
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    print(json.dumps({"event": "fleet_stopped", "status": supervisor.status()},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
