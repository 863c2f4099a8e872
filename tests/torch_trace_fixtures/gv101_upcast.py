"""Poisoned registry: a loop silently upcasts its bf16 state to fp32,
computes, and downcasts back — the shape of "this layer quietly runs in
fp32 every iteration".  GV101 must fire: the upcast reaches neither the
loop's accumulator nor a reduction."""

from raft_stereo_tpu_torch.analysis.trace.registry import TraceEntry, TraceRegistry


def program(h):
    import torch
    steps = torch.zeros((), dtype=torch.float32)
    for _ in range(4):
        h32 = h.float()                       # the poisoned upcast
        h = (h32 * 1.5).to(torch.bfloat16)
        steps = steps + 1.0
    return h, steps


def build_registry():
    def build():
        import torch
        return program, (torch.ones((64, 64, 16), dtype=torch.bfloat16),)

    def region():
        from raft_stereo_tpu_torch.analysis.trace.graphs import loop_region
        return loop_region(program, "steps")

    entry = TraceEntry(name="fixture/upcast", build=build, env={}, mixed_precision=True)
    return TraceRegistry(geometry="fixture", entries=[entry],
                         ladder_variants=[], knob_flips=[], region=region)
