"""Poisoned registry: a train step that rebinds each parameter to a newly
computed tensor instead of updating it in place — two copies of the
parameters live at the step's peak.  GV105 must fire, naming both
leaves."""

from raft_stereo_tpu_torch.analysis.trace.registry import TraceEntry, TraceRegistry


def build_registry():
    def build():
        import torch
        torch.manual_seed(0)
        model = torch.nn.Linear(64, 64)

        def step(x):
            loss = model(x).square().mean()
            loss.backward()
            with torch.no_grad():
                for p in model.parameters():
                    p.data = p - 0.1 * p.grad          # the poisoned rebinding
                    p.grad = None
            return loss.detach()
        return step, (torch.ones((8, 64)),), lambda: dict(model.named_parameters())

    entry = TraceEntry(name="fixture/no_donation", build=build, env={}, in_place=True)
    return TraceRegistry(geometry="fixture", entries=[entry],
                         ladder_variants=[], knob_flips=[])
