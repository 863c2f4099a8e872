"""The port's training and evaluation CLIs and the FlyingThings validator on
the CPU, on a synthetic tree: ``python -m raft_stereo_tpu_torch.train_stereo
--device cpu`` trains, checkpoints and resumes from its checkpoint
directory; ``python -m raft_stereo_tpu_torch.evaluate_stereo`` runs the
validator, and with ``--spatial_shard 2`` in one process exits before the
model is built, with the JAX package's message (two processes run it in
test_torch_multihost.py; the trainer's own check is in
test_torch_engine.py).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo
from raft_stereo_tpu_torch.data.synthetic import write_things_tree
from raft_stereo_tpu_torch.engine import checkpoint as ckpt
from raft_stereo_tpu_torch.engine import evaluate as ev

REPO = Path(__file__).resolve().parents[1]
TINY = dict(hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
TINY_FLAGS = ["--hidden_dims", "32", "32", "32", "--corr_levels", "2", "--corr_radius", "2"]
# The CLIs' processes on two threads each, as this file's own torch: the
# suite runs several files at once.
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def things(tmp_path_factory):
    root = tmp_path_factory.mktemp("things")
    return write_things_tree(str(root), n_train=6, n_test=1, h=48, w=80, max_disp=6.0, seed=3)


def test_validate_things_and_evaluate_cli(things):
    model = init_raft_stereo(RAFTStereoConfig(**TINY), device="cpu")
    res = ev.validate_things(model, model.cfg, iters=2, root=things)
    assert set(res) == {"things-epe", "things-d1"} and np.isfinite(res["things-epe"])
    out = subprocess.run(
        [sys.executable, "-m", "raft_stereo_tpu_torch.evaluate_stereo", "--dataset", "things",
         "--dataset_root", things, "--valid_iters", "2", "--device", "cpu", *TINY_FLAGS],
        cwd=REPO, env=ENV, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Validation FlyingThings" in out.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "raft_stereo_tpu_torch.evaluate_stereo", "--dataset", "things",
         "--spatial_shard", "2", "--device", "cpu"], cwd=REPO,
        env=ENV, capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0
    assert "--spatial_shard 2 does not divide the 1 available device(s)" in bad.stderr


def test_train_cli_trains_checkpoints_and_resumes(things, tmp_path):
    base = [sys.executable, "-m", "raft_stereo_tpu_torch.train_stereo", "--device", "cpu",
            "--dataset_root", things, "--batch_size", "2", "--image_size", "32", "48",
            "--train_iters", "2", "--spatial_scale", "-0.2", "0.4", "--saturation_range", "0",
            "1.4", "--mixed_precision", "--corr_implementation", "reg_cuda",
            "--num_workers", "1", *TINY_FLAGS]
    first = subprocess.run(base + ["--num_steps", "2"], cwd=tmp_path, env=ENV,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-2000:]
    final = tmp_path / "checkpoints" / f"raft-stereo{ckpt.CKPT_SUFFIX}"
    assert ckpt.bundle_step(str(final)) == 2
    second = subprocess.run(base + ["--num_steps", "3", "--restore_ckpt", "checkpoints"],
                            cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "Restored full state" in second.stderr and ckpt.bundle_step(str(final)) == 3
    steps = [json.loads(line)["step"] for line in
             (tmp_path / "runs" / "steps.jsonl").read_text().splitlines()]
    assert steps == [0, 1, 2]
