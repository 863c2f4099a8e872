"""Poisoned registry: a breaker rung whose "fallback" records the identical
program (its switch is consulted nowhere), plus a knob flip that changes
the program but NOT the cache key — the stale-program class.  GV102 must
fire twice."""

from raft_stereo_tpu_torch.analysis.trace.registry import (KnobFlip, TraceEntry,
                                                           TraceRegistry)


def _entry(name, mult):
    def build():
        import torch

        def fn(x):
            return x * mult
        return fn, (torch.ones((8, 8)),)
    return TraceEntry(name=name, build=build, env={})


def build_registry():
    base = _entry("fixture/base", 2.0)
    noop_rung = _entry("fixture/noop_rung", 2.0)   # identical program
    flipped = _entry("fixture/flipped", 3.0)       # different program...
    stale = KnobFlip(knob="RAFT_FIXTURE_KNOB", flip_value="0",
                     base=base, flipped=flipped,
                     base_key=("same",), flipped_key=("same",))  # ...same key
    return TraceRegistry(
        geometry="fixture", entries=[base],
        ladder_variants=[("untripped", base), ("noop_rung", noop_rung)],
        knob_flips=[stale])
