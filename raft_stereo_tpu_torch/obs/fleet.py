"""The fleet rollup: fold N per-instance ``/healthz`` documents into ONE
fleet-level health view (the port's copy of the JAX package's
``obs/fleet.py``).

The fleet supervisor (``serve/fleet.py``) polls every instance's
``/healthz``; this module is the pure fold over those documents that
backs ``GET /fleet/healthz``.  It is deliberately arithmetic-only — no
sockets, no process state — so the aggregation contract is testable
without a single subprocess, and the supervisor stays the one owner of
liveness truth (a document here may be one probe interval stale; the
rollup labels each row with its instance uid so the reader can tell
which instance said what).

Aggregation rules (each chosen to keep the fleet number HONEST under
partial data):

- request outcome counts **sum** (the reconciliation surface checked against the
  router's own books);
- capacity ``headroom_rps`` **sums** across instances (independent
  devices serve independently) while ``saturation`` reports the **max**
  (the fleet is as saturated as its busiest member — averaging would
  hide one pegged instance behind three idle ones);
- ``fingerprint_id`` collects the distinct set: more than one entry
  means a rolling deploy is mid-flight (or failed half-way — the
  supervisor's generation field disambiguates);
- stream sessions / cache entries sum; uptime reports the min (the
  youngest instance bounds how warm the fleet can be).

Import-light like every obs module: stdlib only.
"""

from __future__ import annotations

from typing import Dict, List, Optional

#: /fleet/healthz document schema version.
FLEET_SCHEMA = 1


def _num(doc: Dict, *path, default=None):
    """Defensive nested read: a crashed instance's last document may be
    truncated or absent — a rollup that throws on one bad row would turn
    a single-instance failure into a fleet-health outage."""
    cur: object = doc
    for key in path:
        if not isinstance(cur, dict) or key not in cur:
            return default
        cur = cur[key]
    return cur


def rollup(rows: List[Dict]) -> Dict:
    """Fold per-instance health rows into the fleet document.

    Each row is ``{"uid": ..., "state": ..., "doc": <instance /healthz
    or None>}`` — exactly what the supervisor holds per instance.  Rows
    whose ``doc`` is None (never probed, or dead before first probe)
    still count toward ``instances``/state tallies so the fleet size is
    never under-reported.
    """
    requests: Dict[str, int] = {}
    states: Dict[str, int] = {}
    fingerprints: List[str] = []
    headroom = 0.0
    headroom_seen = False
    saturation: Optional[float] = None
    stream_sessions = 0
    cache_entries = 0
    uptime_min: Optional[float] = None
    # chips SUM across instances (each instance's mesh drives
    # its own devices — a 4-instance fleet of 2-chip meshes advertises
    # an 8-chip pod) and quarantined chips sum the same way.
    chips = 0
    chips_seen = False
    chips_quarantined = 0
    # MTTR reports the MAX across instances (the fleet
    # recovered only when its slowest member did — averaging would hide
    # one slow recovery behind fast peers, the saturation argument
    # again); recovery events sum.
    mttr_last: Optional[float] = None
    heal_events = 0
    per_instance = []
    for row in rows:
        state = str(row.get("state", "unknown"))
        states[state] = states.get(state, 0) + 1
        doc = row.get("doc")
        entry = {"uid": row.get("uid"), "state": state}
        if isinstance(doc, dict):
            reqs = _num(doc, "requests", default={})
            for outcome, n in (reqs.items()
                               if isinstance(reqs, dict) else ()):
                requests[outcome] = requests.get(outcome, 0) + int(n)
                entry.setdefault("requests", {})[outcome] = int(n)
            fp = _num(doc, "fingerprint_id")
            if fp is not None:
                entry["fingerprint_id"] = fp
                if fp not in fingerprints:
                    fingerprints.append(fp)
            up = _num(doc, "uptime_s")
            if up is not None:
                entry["uptime_s"] = up
                uptime_min = up if uptime_min is None else min(
                    uptime_min, up)
            by_bucket = _num(doc, "capacity", "by_bucket", default={})
            inst_headroom = 0.0
            inst_seen = False
            for m in (by_bucket or {}).values():
                h = m.get("headroom_rps") if isinstance(m, dict) else None
                if h is not None:
                    inst_headroom += float(h)
                    inst_seen = True
            if inst_seen:
                headroom += inst_headroom
                headroom_seen = True
                entry["headroom_rps"] = inst_headroom
            ratio = _num(doc, "capacity", "saturation", "ratio")
            if ratio is not None:
                entry["saturation"] = ratio
                saturation = (float(ratio) if saturation is None
                              else max(saturation, float(ratio)))
            stream_sessions += int(
                _num(doc, "stream", "sessions", default=0) or 0)
            cache_entries += int(
                _num(doc, "cache", "entries", default=0) or 0)
            n_chips = _num(doc, "capacity", "chips", "n_data")
            if n_chips is not None:
                chips += int(n_chips)
                chips_seen = True
                entry["chips"] = int(n_chips)
                q = _num(doc, "capacity", "chips", "quarantined",
                         default=()) or ()
                chips_quarantined += len(q)
            m = _num(doc, "heal", "mttr", "last_s")
            if m is not None:
                entry["mttr_last_s"] = float(m)
                mttr_last = (float(m) if mttr_last is None
                             else max(mttr_last, float(m)))
            heal_events += int(
                _num(doc, "heal", "mttr", "events", default=0) or 0)
        per_instance.append(entry)
    return {
        "schema": FLEET_SCHEMA,
        "instances": len(rows),
        "states": states,
        "requests": requests,
        "fingerprints": fingerprints,
        "rolling": len(fingerprints) > 1,
        "headroom_rps": headroom if headroom_seen else None,
        "saturation": saturation,
        "chips": chips if chips_seen else None,
        "chips_quarantined": chips_quarantined if chips_seen else None,
        "mttr_last_s": mttr_last,
        "heal_events": heal_events,
        "stream_sessions": stream_sessions,
        "cache_entries": cache_entries,
        "uptime_min_s": uptime_min,
        "by_instance": per_instance,
    }
