"""Poisoned registry: a debugging ``.item()`` left in a program — the host
waits for the card mid-program, and a CUDA graph capture would bake the
value in.  GV103 must fire."""

from raft_stereo_tpu_torch.analysis.trace.registry import TraceEntry, TraceRegistry


def build_registry():
    def build():
        import torch

        def fn(x):
            y = x * 2.0
            mean = y.mean().item()               # the poisoned host read
            return y + mean
        return fn, (torch.ones((16, 16)),)

    entry = TraceEntry(name="fixture/host_sync", build=build, env={})
    return TraceRegistry(geometry="fixture", entries=[entry],
                         ladder_variants=[], knob_flips=[])
