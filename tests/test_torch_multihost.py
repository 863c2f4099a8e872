"""Training on several processes in the port, on the CPU over gloo: the grid
train steps against the JAX package, the multi-process pod (lead-only
writes, each process decoding only its rows, the pod-wide preemption) and
the CLIs' ``--spatial_shard 2``.

- Train steps (``tests/torch_ranks.py``): one data-parallel (2, 1) and one
  height-sharded (1, 2) step of the port's ``TrainStep`` against the JAX package's single-device ``make_train_step`` on the same
  global batch, with the JAX package's own tolerances
  (``tests/test_parallel.py``: loss rtol 1e-4, parameters atol 1e-5 at its
  lr 1e-4; the gradient norm rtol 1e-4 too), fp32; the gradients each step
  took, summed over the ranks and unclipped, per leaf against the port's
  one-process gradients of the batch (relative L2, ``GRID_GRAD_BAND``).
  The batch's valid
  mask leaves the two height shards different numbers of valid pixels, so a
  mean of the shards' means would show. (The (2, 2) step rides the 4-rank
  launch of test_torch_parallel.py.)
- The pod (the JAX package's ``tests/test_multihost.py``, its two runs as
  one): two processes run ``engine/train.train`` on a synthetic
  FlyingThings tree, batch 4 over a (2, 1) grid, a bundle every step; the
  lead writes the bundles and the logs, the other writes nothing; each
  decodes only its two rows of every global batch. The pod resumes from a
  bundle of step 5 (other weights than the seed's, an optimizer past its
  first step) that only the lead's ``checkpoints/`` holds, the non-lead's
  being empty: both start at step 5 and end with the same parameters.
  Three steps on, SIGTERM to the non-lead stops both at the same step and
  the lead writes a ``_preempt_`` bundle of it, no final one (a finished
  multi-process run's final bundle: the train CLI's case).
- The CLIs: ``train_stereo --spatial_shard 2`` and ``evaluate_stereo
  --spatial_shard 2`` as two processes each; the evaluation's metrics equal
  the one-process validator's within the printed precision.

Every child process runs on two threads (``OMP_NUM_THREADS=2``).
"""

import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.engine.optimizer import make_optimizer as jx_make_optimizer
from raft_stereo_tpu.engine.steps import make_train_step as jx_make_train_step

from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo
from raft_stereo_tpu_torch.data.synthetic import write_things_tree
from raft_stereo_tpu_torch.engine import checkpoint as ckpt
from raft_stereo_tpu_torch.engine import evaluate as ev
from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
from raft_stereo_tpu_torch.engine.steps import make_train_step
from raft_stereo_tpu_torch.parallel import make_mesh
from raft_stereo_tpu_torch.transplant import params_from_jax
from tests.test_torch_train import jax_params, port_grads, port_model
from tests.torch_ranks import (GRID_GRAD_BAND, REPO, TRAIN, TRAIN_ITERS, TRAIN_OPT, free_port,
                               launch, train_batch)

TINY = dict(hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
TINY_FLAGS = ["--hidden_dims", "32", "32", "32", "--corr_levels", "2", "--corr_radius", "2"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _env(port: int, rank: int, world: int = 2) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
               COORDINATOR_ADDRESS=f"localhost:{port}", PROCESS_ID=str(rank),
               NUM_PROCESSES=str(world))
    env.pop("JAX_PLATFORMS", None)
    return env


def _spawn(argv, cwd, world: int = 2):
    """``world`` processes of ``argv`` as one pod."""
    port = free_port()
    procs = []
    for rank in range(world):
        wd = Path(cwd) / f"proc{rank}"
        wd.mkdir(parents=True, exist_ok=True)
        procs.append(subprocess.Popen(argv, cwd=wd, env=_env(port, rank, world),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def _finish(procs, timeout: float = 300.0):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{out[-4000:]}"
    return outs


# The pod's processes: engine/train.train with every decoded batch slot
# recorded (its place in the global batch).
POD = r"""
import sys
import torch
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data.loader import StereoLoader
from raft_stereo_tpu_torch.engine.train import train

import raft_stereo_tpu_torch.engine.train as T

models = []
_init = T.init_raft_stereo
T.init_raft_stereo = lambda *a, **k: models.append(_init(*a, **k)) or models[-1]
slots = []
_load = StereoLoader._load
def counted(self, index, epoch, position):
    slots.append(position % self.batch_size)
    return _load(self, index, epoch, position)
StereoLoader._load = counted

cfg = RAFTStereoConfig(hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
tcfg = TrainConfig(name="mh", batch_size=4, image_size=(32, 48), num_steps=int(sys.argv[2]),
                   train_iters=2, ckpt_every=int(sys.argv[3]), num_workers=1,
                   spatial_scale=(-0.2, 0.4), restore_ckpt="checkpoints")
result = train(cfg, tcfg, data_root=sys.argv[1], validate=False, device="cpu")
import torch.distributed as dist
print("RAFT_MH_STEP", int(result["step"]))
print("RAFT_MH_PARAMS", repr(sum(float(p.double().sum()) for p in models[0].parameters())))
print("RAFT_MH_SLOTS", sorted(set(slots)), len(slots))
print("RAFT_MH_DONE", dist.get_rank(), dist.get_world_size())
"""


@pytest.fixture(scope="module")
def things(tmp_path_factory):
    root = tmp_path_factory.mktemp("things")
    return write_things_tree(str(root), n_train=8, n_test=1, h=96, w=128, max_disp=6.0, seed=3)


@pytest.fixture(scope="module")
def pods(tmp_path_factory, things):
    """Every multi-process run of this file, started at once; the train
    steps' references are computed while they run."""
    d = tmp_path_factory.mktemp("pods")
    model = port_model(TRAIN, seed=1)
    inp = {"train_cfg": TRAIN, "train_sd": model.state_dict(), "train_iters": TRAIN_ITERS,
           "train_opt": TRAIN_OPT}
    torch.save(inp, d / "inputs.pt")
    wait_steps = launch("train2", 2, d, d / "train2")
    code = [sys.executable, "-c", POD, things]
    runs = {}
    try:
        _resume_bundle(d / "pod")
        runs["pod"] = _spawn(code + ["500", "1"], d / "pod")
        tiny = [*TINY_FLAGS, "--device", "cpu"]
        runs["train_cli"] = _spawn(
            [sys.executable, "-m", "raft_stereo_tpu_torch.train_stereo", "--dataset_root",
             things, "--batch_size", "2", "--image_size", "64", "96", "--train_iters", "2",
             "--num_steps", "2", "--num_workers", "1", "--spatial_shard", "2", *tiny],
            d / "train_cli")
        runs["eval_cli"] = _spawn(
            [sys.executable, "-m", "raft_stereo_tpu_torch.evaluate_stereo", "--dataset",
             "things", "--dataset_root", things, "--valid_iters", "2", "--spatial_shard", "2",
             *tiny], d / "eval_cli")
        # The pod is signalled as soon as it is past step 3, while the
        # references are computed (it trains until then).
        with ThreadPoolExecutor(max_workers=1) as ex:
            signalled = ex.submit(_preempt_non_lead, runs["pod"], d / "pod")
            refs = _train_refs(inp, model)
            signalled.result()
        yield d, refs, wait_steps(), runs
    finally:
        # Leave no process of this file running: after a failure, or a
        # test that did not run to wait for its pod.
        for p in [*wait_steps.procs, *(q for procs in runs.values() for q in procs
                                       if isinstance(q, subprocess.Popen))]:
            if p.poll() is None:
                p.kill()
                p.wait()


RESUME_STEP = 5


def _resume_bundle(d: Path) -> None:
    """The bundle the pod resumes from, in the lead's ``checkpoints/`` only
    (the non-lead's is empty): step 5, weights of another seed than the
    run's, and an optimizer past one step of seeded gradients."""
    model = init_raft_stereo(RAFTStereoConfig(**TINY), seed=7, device="cpu")
    opt = make_optimizer(model, 2e-4, 500, 1e-5, skip_nonfinite=5)
    g = torch.Generator().manual_seed(7)
    for p in model.parameters():
        p.grad = 1e-2 * torch.randn(p.shape, generator=g)
    opt.step(True)
    ckpt.save_checkpoint(str(d / "proc0" / "checkpoints" / f"{RESUME_STEP}_mh{ckpt.CKPT_SUFFIX}"),
                         model, opt, RESUME_STEP)
    (d / "proc1" / "checkpoints").mkdir(parents=True)


def _preempt_non_lead(procs, d: Path) -> None:
    """SIGTERM the non-lead once the lead has written the bundle of the
    third step after the resume or a later one (the oldest are pruned)."""
    ckpts = d / "proc0" / "checkpoints"
    deadline = time.time() + 240
    try:
        while not any(ckpt.bundle_step(str(f)) >= RESUME_STEP + 3
                      for f in ckpts.glob(f"*_mh{ckpt.CKPT_SUFFIX}")):
            assert time.time() < deadline, "the pod never reached its third step"
            assert all(p.poll() is None for p in procs), "a process died early"
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
    except BaseException:
        for p in procs:
            p.kill()
        raise


def _ckpts(d: Path, rank: int):
    c = d / f"proc{rank}" / "checkpoints"
    return sorted(os.listdir(c)) if c.is_dir() else []


def _train_refs(inp, model):
    """JAX's single-device train step and the port's one-process gradients
    (fp32, and its fp64 copy for the rounding term) on the global batch."""
    batch = train_batch()
    jcfg = JaxConfig(**TRAIN)
    params = jax_params(model, TRAIN)
    tx, _ = jx_make_optimizer(*TRAIN_OPT, skip_nonfinite=3)
    step = jx_make_train_step(jcfg, tx, train_iters=TRAIN_ITERS)
    new, _, metrics = step(jax.tree_util.tree_map(jnp.copy, params), jax.jit(tx.init)(params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    after = params_from_jax(jax.tree_util.tree_map(np.asarray, new), RAFTStereoConfig(**TRAIN))
    import tests.test_torch_train as tt
    saved = tt.ITERS
    tt.ITERS = TRAIN_ITERS
    try:
        loss, g32 = port_grads(model, batch)
    finally:
        tt.ITERS = saved
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {k: v.numpy() for k, v in after.items()}, "port_loss": loss,
            "g32": g32}


# -- the train step on a grid ----------------------------------------------------


@pytest.mark.parametrize("tag", ["train_data", "train_space"])
def test_grid_train_step_matches_the_single_device_step(pods, tag):
    _, ref, ranks, _ = pods
    valid = train_batch()["valid"]
    assert valid[:, :32].sum() != valid[:, 32:].sum()
    host = ranks[0][tag]["host"]
    assert host["applied"] == 1.0 and host["finite"] == 1.0
    np.testing.assert_allclose(host["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(host["loss"], ref["port_loss"], rtol=1e-5)
    np.testing.assert_allclose(host["grad_norm"], ref["grad_norm"], rtol=1e-4)
    params = ranks[0][tag]["params"]
    for r in ranks[1:]:
        assert all(np.array_equal(params[n], r[tag]["params"][n]) for n in params)
    for n, p in params.items():
        np.testing.assert_allclose(p, ref["params"][n], atol=1e-5, err_msg=n)
    # The gradients the step took, unclipped, per leaf against the port's
    # one-process gradients of the global batch.
    scale = 1.0 / max(host["grad_norm"], 1.0)
    grads = {n: g / scale for n, g in ranks[0][tag]["grads"].items()}
    # Leaves the configuration leaves unused (the third level's context
    # head at two levels) have no gradient on either side.
    assert set(grads) <= set(ref["g32"])
    assert all(not np.abs(ref["g32"][n]).max() for n in set(ref["g32"]) - set(grads))
    floor = 1e-2 * max(float(np.linalg.norm(g)) for g in ref["g32"].values())
    worst = max((float(np.linalg.norm(g - ref["g32"][n])
                       / max(np.linalg.norm(ref["g32"][n]), floor)), n) for n, g in grads.items())
    print(tag, "gradients, worst relative L2", worst)
    assert worst[0] <= GRID_GRAD_BAND, worst


def test_one_process_grid_step_is_the_plain_step():
    """A grid of one process (the launch without COORDINATOR_ADDRESS) steps
    exactly as no grid: the same loss and the same parameters."""
    from raft_stereo_tpu_torch.parallel import make_mesh
    grid = make_mesh()
    assert (grid.n_data, grid.n_space) == (1, 1) and grid.is_lead
    batch = {k: torch.from_numpy(v) for k, v in train_batch().items()}
    out = []
    for g in (None, grid):
        model = port_model(TRAIN, seed=1)
        step = make_train_step(model, make_optimizer(model, *TRAIN_OPT), 1, grid=g)
        out.append((step(batch), [p.detach().clone() for p in model.parameters()]))
    assert out[0][0]["loss"] == out[1][0]["loss"]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# -- the pod ---------------------------------------------------------------------


def _pod_outputs(runs) -> list:
    if "pod_out" not in runs:
        runs["pod_out"] = _finish(runs["pod"])
    return runs["pod_out"]


def test_two_process_pod_trains_and_lead_writes(pods):
    d, _, _, runs = pods
    outs = _pod_outputs(runs)
    pod = d / "pod"
    lead = _ckpts(pod, 0)
    assert any("_preempt_" not in f for f in lead), lead  # the periodic bundles
    assert _ckpts(pod, 1) == [] and not (pod / "proc1" / "runs").exists()
    steps = (pod / "proc0" / "runs" / "steps.jsonl").read_text().splitlines()
    assert len(steps) >= 3 and json.loads(steps[0])["step"] == RESUME_STEP, steps[:1]
    for rank, out in enumerate(outs):
        assert f"RAFT_MH_DONE {rank} 2" in out, out[-2000:]
        line = next(x for x in out.splitlines() if x.startswith("RAFT_MH_SLOTS"))
        # Rank r decodes only rows 2r, 2r + 1 of each global batch of 4.
        assert line.split(" ", 1)[1].startswith(f"[{2 * rank}, {2 * rank + 1}]"), line


def _printed(out: str, tag: str) -> str:
    return next(x for x in out.splitlines() if x.startswith(tag)).split()[1]


def test_pod_resumes_from_the_leads_bundle(pods):
    """Only the lead's directory holds the bundle: the non-lead takes the
    lead's model, optimizer and step, so both end with the same
    parameters (the non-lead from its own seed and step 0 would not)."""
    _, _, _, runs = pods
    outs = _pod_outputs(runs)
    assert len({_printed(out, "RAFT_MH_PARAMS") for out in outs}) == 1, outs[1][-2000:]
    assert all(int(_printed(out, "RAFT_MH_STEP")) > RESUME_STEP for out in outs)


def test_preemption_of_one_process_stops_the_pod(pods):
    """SIGTERM only the non-lead: both processes stop at the same step, and
    the lead writes a preempt bundle of that step, no final one."""
    d, _, _, runs = pods
    outs = _pod_outputs(runs)
    steps = {int(_printed(out, "RAFT_MH_STEP")) for out in outs}
    assert len(steps) == 1, steps
    lead = _ckpts(d / "pod", 0)
    preempt = [f for f in lead if "_preempt_" in f]
    assert len(preempt) == 1, lead
    assert ckpt.bundle_step(str(d / "pod" / "proc0" / "checkpoints" / preempt[0])) == steps.pop()
    assert f"mh{ckpt.CKPT_SUFFIX}" not in lead


def test_train_cli_accepts_spatial_shard(pods):
    d, _, _, runs = pods
    outs = _finish(runs["train_cli"])
    final = d / "train_cli" / "proc0" / "checkpoints" / f"raft-stereo{ckpt.CKPT_SUFFIX}"
    assert ckpt.bundle_step(str(final)) == 2, outs[0][-2000:]
    assert _ckpts(d / "train_cli", 1) == []


def test_evaluate_cli_accepts_spatial_shard(pods, things):
    _, _, _, runs = pods
    outs = _finish(runs["eval_cli"])
    lines = [next(x for x in out.splitlines() if x.startswith("Validation FlyingThings"))
             for out in outs]
    assert lines[0] == lines[1]
    model = init_raft_stereo(RAFTStereoConfig(**TINY), device="cpu")
    res = ev.validate_things(model, model.cfg, iters=2, root=things)
    got = [float(x.strip(",")) for x in lines[0].split()[2:4]]
    np.testing.assert_allclose(got, [res["things-epe"], res["things-d1"]], atol=1e-4)
