"""Poisoned registry: a closure holds a 4 MiB tensor the program reads — it
is neither an input, a parameter nor produced in the program, so a
captured graph would keep reading the closure's memory.  GV104 must
fire."""

from raft_stereo_tpu_torch.analysis.trace.registry import TraceEntry, TraceRegistry


def build_registry():
    def build():
        import torch
        table = torch.ones((1024, 1024), dtype=torch.float32)  # 4 MiB, held

        def fn(x):
            return x @ table
        return fn, (torch.ones((4, 1024)),)

    entry = TraceEntry(name="fixture/big_const", build=build, env={})
    return TraceRegistry(geometry="fixture", entries=[entry],
                         ladder_variants=[], knob_flips=[])
