"""GV102 — breaker-ladder vacuity + env-knob cache-key sufficiency.

Two halves of one invariant: *every degree of freedom the serving layer
believes in must exist in the recorded program, and every degree of
freedom in the recorded program must exist in the cache key.*

Ladder half: each rung of ``serve/guard.py``'s ``DEFAULT_LADDER``, when
tripped on top of its predecessors, must record a DIFFERENT program at
headline (pairwise: no two trip sets may share a program).  A vacuous rung
means the breaker "falls back" to the identical program — the retry after
a trip re-runs the exact failure.  On the card the recording includes the
hand-written kernels' launches, so a rung that turns a kernel off shows.

Knob half: flipping each registered ``ENV_KNOBS`` entry (with its probe
value) must change the recorded program IFF it changes the program-cache
key (``config_fingerprint`` and the session's ``cache_key``):

- program changed, key unchanged -> the stale-program class;
- key changed, program unchanged -> a dead knob or a wrong probe;
- neither changed -> a dead registry entry.
"""

from __future__ import annotations

from typing import Iterator

from raft_stereo_tpu_torch.analysis.core import Finding
from raft_stereo_tpu_torch.analysis.trace.runner import TraceChecker, TraceContext


class LadderVacuityChecker(TraceChecker):
    code = "GV102"
    name = "ladder-vacuity"
    description = ("breaker rung recording an identical program to an "
                   "earlier trip set / env knob whose program and cache-key "
                   "effects disagree")

    def check(self, ctx: TraceContext) -> Iterator[Finding]:
        variants = ctx.registry.ladder_variants
        for j, (label, cur) in enumerate(variants[1:], start=1):
            cur_text = ctx.text(cur)
            if cur_text is None:
                continue  # recording failure already reported as GV000
            for i in range(j):
                prev_label, prev = variants[i]
                prev_text = ctx.text(prev)
                if prev_text is None or prev_text != cur_text:
                    continue
                how = ("its predecessor" if i == j - 1
                       else f"the earlier trip set through {prev_label!r}")
                yield self.finding(
                    f"ladder:{label}",
                    f"tripping rung {label!r} records a program IDENTICAL "
                    f"to {how} at {ctx.registry.geometry} geometry — the "
                    "fallback is vacuous: a breaker trip would re-run a "
                    "program that already failed")
                break  # one finding per rung is enough

        for kf in ctx.registry.knob_flips:
            if kf.flipped is None:
                yield self.finding(
                    f"knob:{kf.knob}",
                    f"env knob {kf.knob!r} is registered in ENV_KNOBS but "
                    "has no flip probe in KNOB_FLIP_PROBES "
                    "(analysis/trace/registry.py) — declare a value that "
                    "changes the program so GV102 can keep proving the "
                    "cache key covers it")
                continue
            base_text, flip_text = ctx.text(kf.base), ctx.text(kf.flipped)
            if base_text is None or flip_text is None:
                continue
            program_changed = base_text != flip_text
            key_changed = kf.base_key != kf.flipped_key
            if program_changed and not key_changed:
                yield self.finding(
                    f"knob:{kf.knob}",
                    f"flipping {kf.knob}={kf.flip_value!r} CHANGES the "
                    "recorded program but NOT the program-cache key — the "
                    "stale-program class: requests under different switch "
                    "values would share one captured program (fold the "
                    "knob into config_fingerprint / ENV_KNOBS)")
            elif key_changed and not program_changed:
                yield self.finding(
                    f"knob:{kf.knob}",
                    f"flipping {kf.knob}={kf.flip_value!r} changes the "
                    "cache key but NOT the recorded program at "
                    f"{ctx.registry.geometry} geometry — dead cache-key "
                    "bloat or a wrong probe value; fix the probe "
                    "(KNOB_FLIP_PROBES) or justify the registry entry")
            elif not key_changed and not program_changed:
                yield self.finding(
                    f"knob:{kf.knob}",
                    f"flipping {kf.knob}={kf.flip_value!r} changes "
                    "neither the program nor the cache key — a dead "
                    "registry entry (or the knob is no longer consulted "
                    "anywhere the recording can see)")
