"""graftheal — recovery-plane pacing knobs (DESIGN.md "The recovery
plane (r22)").

A copy of the JAX package's ``serve/heal.py``.

The serving stack built graceful *degradation* at every layer — breaker
rungs trip to plain XLA, mesh chips quarantine and the mesh shrinks,
fleet slots exhaust their restart budget and go dark — but every one of
those ladders was one-way for the session/generation lifetime.  This
module holds the shared pacing knobs for the half-open probation state
machine that re-engages all three (serve/guard.py rungs,
serve/session.py chips, serve/fleet.py slots).

All of these are HOST-side recovery *pacing*: when a probe is allowed
to run, how many flaps are tolerated, how fast a restart budget
refills.  None of them ever shapes a compiled program — the re-engaged
configuration is keyed exactly the way tripping keyed it (the trip set
/ mesh epoch are already in the program-cache key projection), so these
knobs live in ``HOST_ENV_KNOBS``, never in any program fingerprint.

Knobs (explicit config wins, else env, else default — the resolve_*
convention from serve/supervise.py, with its named-ValueError parser):

- ``RAFT_HEAL``             — master switch; default ON.  ``0`` is the
  kill switch that restores the one-way degradation semantics exactly.
- ``RAFT_HEAL_BACKOFF_MS``  — initial probation backoff per rung/chip
  (default 30 s).  Doubles on every failed probe.
- ``RAFT_HEAL_BACKOFF_MAX_MS`` — backoff doubling cap (default 480 s).
- ``RAFT_HEAL_FLAP_CAP``    — chip re-admissions tolerated per window
  before the chip is permanently quarantined (default 2).
- ``RAFT_HEAL_WINDOW_MS``   — the flap-counting window (default 600 s).
- ``RAFT_HEAL_REFILL_MS``   — fleet restart-budget decay: one restart
  charge is refunded per this interval (default 60 s).

Clock discipline: every deadline here runs on the owning component's
session clock (``faults.FakeClock`` in tests/storms), except the fleet
refill which rides the fleet's ``time.monotonic`` clock seam — the
fleet supervisor has no FakeClock and its tests inject tiny refill
intervals instead.
"""

from __future__ import annotations

import os
from typing import Optional

# ONE named-ValueError parser for env knobs (the SLURM_CPUS_PER_TASK
# convention) — the ``os.environ`` reads stay LITERAL at each
# resolve_* site below so GL002's registry cross-check can see them.
from raft_stereo_tpu_torch.serve.supervise import _parse_number

#: Recovery is ON by default: the kill switch is ``RAFT_HEAL=0``.
DEFAULT_HEAL_ENABLED = True

#: First probation backoff: a transient 30 s fault (the motivating
#: preemption hiccup) gets exactly one backoff period before the first
#: half-open probe.
DEFAULT_HEAL_BACKOFF_MS = 30_000.0

#: Backoff doubling cap: 30 s * 2^4 = 480 s — a persistently failing
#: probe settles at one canary per 8 minutes, which is noise against
#: serving but still finds an eventually-cleared fault within minutes.
DEFAULT_HEAL_BACKOFF_MAX_MS = 480_000.0

#: Chip flap cap: K re-admissions per window, then permanently out.  A
#: mesh re-grow is an epoch bump (re-keyed programs, re-warm) — a chip
#: flapping faster than this would thrash epochs into a recompile
#: storm, which is worse than serving shrunk.
DEFAULT_HEAL_FLAP_CAP = 2

#: The flap-counting window (session clock).
DEFAULT_HEAL_WINDOW_MS = 600_000.0

#: Fleet restart-budget decay: one charge refunded per interval, so an
#: exhausted slot re-enters probation (one relaunch at a time) instead
#: of staying dark until the next deploy.
DEFAULT_HEAL_REFILL_MS = 60_000.0


def resolve_heal_enabled(value: Optional[bool] = None) -> bool:
    """Effective recovery-plane switch: explicit config wins, else
    ``RAFT_HEAL`` (``0`` disables), else ON.  The kill switch restores
    the one-way degradation semantics bit-for-bit — no probes, no
    refills, no re-admissions."""
    if value is not None:
        return bool(value)
    raw = os.environ.get("RAFT_HEAL", "").strip()
    if not raw:
        return DEFAULT_HEAL_ENABLED
    return raw != "0"


def resolve_heal_backoff_ms(value: Optional[float] = None) -> float:
    """Effective initial probation backoff in ms: explicit config wins,
    else ``RAFT_HEAL_BACKOFF_MS``, else 30 s."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_HEAL_BACKOFF_MS", "").strip()
    if not raw:
        return DEFAULT_HEAL_BACKOFF_MS
    ms = _parse_number("RAFT_HEAL_BACKOFF_MS", raw, float)
    if ms <= 0:
        raise ValueError(f"RAFT_HEAL_BACKOFF_MS must be > 0, got {ms}")
    return ms


def resolve_heal_backoff_max_ms(value: Optional[float] = None) -> float:
    """Effective backoff doubling cap in ms: explicit config wins, else
    ``RAFT_HEAL_BACKOFF_MAX_MS``, else 480 s."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_HEAL_BACKOFF_MAX_MS", "").strip()
    if not raw:
        return DEFAULT_HEAL_BACKOFF_MAX_MS
    ms = _parse_number("RAFT_HEAL_BACKOFF_MAX_MS", raw, float)
    if ms <= 0:
        raise ValueError(
            f"RAFT_HEAL_BACKOFF_MAX_MS must be > 0, got {ms}")
    return ms


def resolve_heal_flap_cap(value: Optional[int] = None) -> int:
    """Effective chip flap cap: explicit config wins, else
    ``RAFT_HEAL_FLAP_CAP``, else 2.  ``0`` means a quarantined chip is
    never re-admitted (quarantine stays one-way while rung/slot healing
    remains armed)."""
    if value is not None:
        return int(value)
    raw = os.environ.get("RAFT_HEAL_FLAP_CAP", "").strip()
    if not raw:
        return DEFAULT_HEAL_FLAP_CAP
    cap = _parse_number("RAFT_HEAL_FLAP_CAP", raw, int)
    if cap < 0:
        raise ValueError(f"RAFT_HEAL_FLAP_CAP must be >= 0, got {cap}")
    return cap


def resolve_heal_window_ms(value: Optional[float] = None) -> float:
    """Effective flap-counting window in ms: explicit config wins, else
    ``RAFT_HEAL_WINDOW_MS``, else 600 s."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_HEAL_WINDOW_MS", "").strip()
    if not raw:
        return DEFAULT_HEAL_WINDOW_MS
    ms = _parse_number("RAFT_HEAL_WINDOW_MS", raw, float)
    if ms <= 0:
        raise ValueError(f"RAFT_HEAL_WINDOW_MS must be > 0, got {ms}")
    return ms


def resolve_heal_refill_ms(value: Optional[float] = None) -> float:
    """Effective fleet restart-budget refill interval in ms: explicit
    config wins, else ``RAFT_HEAL_REFILL_MS``, else 60 s."""
    if value is not None:
        return float(value)
    raw = os.environ.get("RAFT_HEAL_REFILL_MS", "").strip()
    if not raw:
        return DEFAULT_HEAL_REFILL_MS
    ms = _parse_number("RAFT_HEAL_REFILL_MS", raw, float)
    if ms <= 0:
        raise ValueError(f"RAFT_HEAL_REFILL_MS must be > 0, got {ms}")
    return ms
