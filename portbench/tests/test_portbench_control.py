"""The correctness check fails what it must fail.

- The control, the reference one precision below the configurations'
  bf16 (``reference/fp8.py``), put in the port's place: on three seeds
  its answers break a cell's limits, where the port's own (its plain path
  here, the kernels on the card) keep to them.
- A run driven to its end with the timed path broken underneath reads
  ``correct`` false: once with the refinement returning its state
  unchanged, once with an answer altered where the port produces it.

At a small frame on the CPU with the configurations' own widths and
iterations; ``test_control_fails_at_the_cells_size`` repeats the first at
each cell's own size on the card (``-m gpu``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import costs, harness, inputs, judge, spec

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
SMALL = (96, 192)
# The cell whose limits judge each configuration at the small size.
CELL_OF = {"raftstereo-middlebury": "kitti.cam1", "raftstereo-realtime": "realtime.cam1"}


def _port_disparity(arch, weights, left, right, iters):
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.demo import infer_pair
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.transplant import load_state_dict
    port = RAFTStereo(RAFTStereoConfig(corr_implementation="reg_cuda", mixed_precision=True,
                                       **arch)).eval()
    load_state_dict(port, weights)
    return infer_pair(port, left.float()[None], right.float()[None], iters=iters).numpy()


@pytest.mark.parametrize("config", sorted(CELL_OF))
def test_control_fails_where_the_port_passes(config):
    torch.set_num_threads(4)
    cfg = spec.config(config)
    arch, iters = costs.arch_of(cfg), cfg["valid_iters"]
    limits = spec.limits(CELL_OF[config])
    for seed in SEEDS:
        weights = inputs.make_weights(arch, seed, "cpu")
        pair = inputs.make_pairs(1, *SMALL, 16.0, seed + 1, "cpu")[0]
        refs = judge.reference_disparities(judge.reference_model(arch, weights, "cpu"),
                                           lambda i: pair, [0], iters)
        control = judge.reference_disparities(
            judge.reference_model(arch, weights, "cpu", lower=True), lambda i: pair, [0], iters)
        port = _port_disparity(arch, weights, *pair, iters)
        ok_port, checks_port = judge.verdict(judge.numbers([(0, port)], refs), limits)
        ok_ctl, checks_ctl = judge.verdict(judge.numbers([(0, control[0])], refs), limits)
        assert ok_port, (seed, checks_port)
        assert not ok_ctl, (seed, checks_ctl)


FAULT_TRAFFIC = {"height": 64, "width": 96, "pool": 2, "check_answers": 2,
                 "warmup_frames": 1, "warmup_requests": 1}


def _unchanged(monkeypatch):
    """Every refinement segment returns its carry as it came."""
    from raft_stereo_tpu_torch.models import raft_stereo
    from raft_stereo_tpu_torch.serve import session

    def segment_carry(model, state, *, iters, warm_start=False, space=None):
        return state, torch.zeros(state["coords1"].shape[0])
    monkeypatch.setattr(raft_stereo, "raft_stereo_segment_carry", segment_carry)
    monkeypatch.setattr(session, "raft_stereo_segment_carry", segment_carry)


def _altered(monkeypatch):
    """The epilogue's answer moved by 16 px over one 4x4 patch."""
    from raft_stereo_tpu_torch.models import raft_stereo
    from raft_stereo_tpu_torch.serve import session
    real = raft_stereo.raft_stereo_epilogue

    def epilogue(model, state, space=None):
        flow_low, flow_up = real(model, state, space)
        flow_up = flow_up.clone()
        flow_up[:, 8:12, 8:12] -= 16.0
        return flow_low, flow_up
    monkeypatch.setattr(raft_stereo, "raft_stereo_epilogue", epilogue)
    monkeypatch.setattr(session, "raft_stereo_epilogue", epilogue)


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
@pytest.mark.parametrize("fault", [_unchanged, _altered], ids=["unchanged", "altered"])
def test_broken_timed_path_reads_incorrect(cell, fault, monkeypatch):
    torch.set_num_threads(4)
    fault(monkeypatch)
    line = harness.run(cell, SEEDS[0], 0.5, False, device="cpu",
                       overrides={"traffic": FAULT_TRAFFIC})
    assert line["correct"] is False, line["checks"]
    assert any(c["value"] is None or c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench.study import control_values
    for seed in SEEDS:
        keep: dict = {}
        line = harness.run(cell, seed, 3.0, False, keep=keep)
        assert line["correct"], line["checks"]
        ok, checks = judge.verdict(control_values(keep, torch.device("cuda")),
                                   spec.limits(cell))
        assert not ok, checks
        assert np.isfinite(list(keep["values"].values())).all()
