"""The port's training engine on the CPU: the loss against the JAX package's,
the optimizer, checkpoints, the trainer's recovery paths (mirroring
tests/test_engine.py and tests/test_faults.py on the port's trainer alone,
at tiny sizes), the validators and the two CLIs.

- ``sequence_loss`` equals the JAX package's (1e-6) and the reference's
  formula; the 700 px cutoff; ``finite``.
- Checkpoints: the JAX package's framing (magic, sha256, payload), a
  ``torch.save`` payload that loads with ``weights_only=True``, a truncated
  or corrupt bundle refused and skipped by ``find_latest_checkpoint``,
  keep-last-K over valid periodic bundles, the run-name grammar.
- The trainer: a NaN step leaves the parameters and the Adam state bit for
  bit unchanged (``skipped``, ``notfinite_count``); ``max_bad_steps``
  consecutive ones abort; a truncated newest bundle falls back to the one
  before; SIGTERM saves a preempt bundle and a relaunch continues the
  schedule; a run resumed from a bundle equals the uninterrupted one bit for
  bit; a corrupt sample is quarantined and substituted.
- More than one card's worth of work raises before the model is built.

The validators and the two CLIs are in test_torch_train_cli.py.
"""

import json
import os
import os.path as osp
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_stereo_tpu.engine.loss import sequence_loss as jx_sequence_loss

from raft_stereo_tpu_torch import RAFTStereoConfig, TrainConfig, init_raft_stereo
from raft_stereo_tpu_torch.data.loader import StereoLoader
from raft_stereo_tpu_torch.data.synthetic import write_things_tree
from raft_stereo_tpu_torch.engine import checkpoint as ckpt
from raft_stereo_tpu_torch.engine.loss import sequence_loss
from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
from raft_stereo_tpu_torch.engine.steps import make_train_step
from raft_stereo_tpu_torch.engine.train import train
from raft_stereo_tpu_torch.faults import FaultPlan, FaultyDataset, truncate_file

REPO = Path(__file__).resolve().parents[1]
TINY = dict(hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
TINY_FLAGS = ["--hidden_dims", "32", "32", "32", "--corr_levels", "2", "--corr_radius", "2"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def things(tmp_path_factory):
    """A synthetic FlyingThings3D tree: 6 TRAIN and 1 TEST pairs at 48x80."""
    root = tmp_path_factory.mktemp("things")
    return write_things_tree(str(root), n_train=6, n_test=1, h=48, w=80, max_disp=6.0, seed=3)


def _tcfg(**kw):
    base = dict(batch_size=1, image_size=(32, 48), train_iters=2, num_workers=1,
                spatial_scale=(-0.2, 0.4), data_retry_backoff=0.001, num_steps=6,
                ckpt_every=2, keep_ckpts=0, seed=5)
    base.update(kw)
    return TrainConfig(**base)


def _train(things, tmp, faults=None, **kw):
    return train(RAFTStereoConfig(**TINY), _tcfg(**kw), data_root=things, validate=False,
                 device="cpu", log_dir=str(tmp / "runs"), ckpt_dir=str(tmp / "checkpoints"),
                 faults=faults)


def _steps(tmp) -> list:
    return [json.loads(line) for line in (tmp / "runs" / "steps.jsonl").read_text().splitlines()]


# -- loss ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 5])
def test_sequence_loss_matches_jax_and_formula(rng, n):
    b, h, w = 2, 8, 10
    preds = rng.standard_normal((n, b, h, w, 1)).astype(np.float32) * 3
    gt = rng.standard_normal((b, h, w, 1)).astype(np.float32) * 3
    gt[0, 0, 0, 0] = -800.0  # past the cutoff
    valid = (rng.uniform(size=(b, h, w)) > 0.3).astype(np.float32)
    loss, metrics = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                                  torch.from_numpy(valid))
    jloss, jmetrics = jx_sequence_loss(jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-6, err_msg=k)
    gamma = 0.9 ** (15.0 / max(n - 1, 1))
    mask = (valid >= 0.5) & (np.abs(gt[..., 0]) < 700)
    expect = sum(gamma ** (n - i - 1) * np.abs(preds[i, ..., 0] - gt[..., 0])[mask].mean()
                 for i in range(n))
    np.testing.assert_allclose(float(loss), expect, rtol=1e-5)


def test_sequence_loss_cutoff_and_finite():
    loss, m = sequence_loss(torch.zeros(2, 1, 4, 4, 1), torch.full((1, 4, 4, 1), 800.0),
                            torch.ones(1, 4, 4))
    assert float(loss) == 0.0 and float(m["finite"]) == 1.0
    bad = torch.zeros(3, 1, 4, 4, 1)
    bad[1, 0, 2, 2, 0] = float("nan")
    assert float(sequence_loss(bad, torch.zeros(1, 4, 4, 1), torch.ones(1, 4, 4))[1]["finite"]) == 0.0
    bad[1, 0, 2, 2, 0] = float("inf")
    assert float(sequence_loss(bad, torch.zeros(1, 4, 4, 1), torch.ones(1, 4, 4))[1]["finite"]) == 0.0


def test_optimizer_decreases_a_simple_loss(rng):
    p = torch.nn.Parameter(torch.from_numpy(rng.standard_normal(4).astype(np.float32)))
    from raft_stereo_tpu_torch.engine.optimizer import TrainOptimizer
    opt = TrainOptimizer([p], 1e-2, 100)
    l0 = float((p ** 2).sum())
    for _ in range(50):
        opt.zero_grad()
        (p ** 2).sum().backward()
        opt.clip()
        opt.step(True)
    assert float((p ** 2).sum()) < l0


def test_clip_matches_optax_clip_by_global_norm(rng):
    import optax
    vals = [rng.standard_normal(s).astype(np.float32) * 3 for s in ((5, 4), (7,), (2, 3, 3))]
    params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in vals]
    for p, v in zip(params, vals):
        p.grad = torch.from_numpy(v.copy())
    from raft_stereo_tpu_torch.engine.optimizer import TrainOptimizer
    norm, finite = TrainOptimizer(params, 1e-3, 10).clip()
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(v) for v in vals], None)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(
        [jnp.asarray(v) for v in vals])), rtol=1e-6)
    assert bool(finite)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


# -- checkpoints ------------------------------------------------------------------


def _tiny_state():
    model = init_raft_stereo(RAFTStereoConfig(**TINY), device="cpu")
    opt = make_optimizer(model, 2e-4, 10, skip_nonfinite=2)
    return model, opt


def test_checkpoint_round_trip_framing_and_weights_only(tmp_path):
    model, opt = _tiny_state()
    path = ckpt.save_checkpoint(str(tmp_path / f"3_run{ckpt.CKPT_SUFFIX}"), model, opt, 3)
    blob = Path(path).read_bytes()
    from raft_stereo_tpu.engine import checkpoint as jx_ckpt
    assert blob.startswith(jx_ckpt._MAGIC) and len(ckpt._MAGIC) == len(jx_ckpt._MAGIC)
    import hashlib
    assert hashlib.sha256(blob[ckpt._HEADER_LEN:]).digest() == blob[len(ckpt._MAGIC):ckpt._HEADER_LEN]
    import io
    raw = torch.load(io.BytesIO(blob[ckpt._HEADER_LEN:]), weights_only=True)
    assert raw["step"] == 3 and set(raw) == {"model", "optimizer", "step"}
    other, opt2 = _tiny_state()
    with torch.no_grad():
        for p in other.parameters():
            p.add_(1.0)
    _, _, step = ckpt.load_checkpoint(path, other, opt2)
    assert step == 3 and ckpt.bundle_step(path) == 3
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 other.state_dict().values()))
    assert ckpt.validate_checkpoint(path)
    truncate_file(path)
    assert not ckpt.validate_checkpoint(path)
    with pytest.raises(ckpt.CheckpointError):
        ckpt.load_checkpoint(path)
    legacy = tmp_path / f"legacy{ckpt.CKPT_SUFFIX}"
    torch.save({"model": {}, "optimizer": None, "step": 7}, legacy)
    assert ckpt.validate_checkpoint(str(legacy)) and ckpt.bundle_step(str(legacy)) == 7


def test_find_latest_skips_corrupt_and_prune_keeps_valid(tmp_path):
    model, opt = _tiny_state()
    d = str(tmp_path)
    for s in (2, 4, 6, 8):
        ckpt.save_checkpoint(osp.join(d, f"{s}_run{ckpt.CKPT_SUFFIX}"), model, opt, s)
    ckpt.save_checkpoint(osp.join(d, f"5_preempt_run{ckpt.CKPT_SUFFIX}"), model, opt, 5)
    ckpt.save_checkpoint(osp.join(d, f"9_other{ckpt.CKPT_SUFFIX}"), model, opt, 9)
    truncate_file(osp.join(d, f"8_run{ckpt.CKPT_SUFFIX}"))
    assert ckpt.find_latest_checkpoint(d, name="run").endswith(f"6_run{ckpt.CKPT_SUFFIX}")
    ckpt.save_checkpoint(osp.join(d, f"run{ckpt.CKPT_SUFFIX}"), model, opt, 7)
    assert ckpt.find_latest_checkpoint(d, name="run", include_final=True).endswith(
        f"/run{ckpt.CKPT_SUFFIX}")
    removed = ckpt.prune_checkpoints(d, "run", keep=2)
    left = sorted(os.listdir(d))
    # 8 is corrupt (kept, inside the window), 6 and 4 are the two valid.
    assert [osp.basename(p) for p in removed] == [f"2_run{ckpt.CKPT_SUFFIX}"]
    assert f"5_preempt_run{ckpt.CKPT_SUFFIX}" in left and f"9_other{ckpt.CKPT_SUFFIX}" in left


@pytest.mark.parametrize("name", ["12_run", "preempt_x", "epoch_v2"])
def test_run_name_grammar(name):
    with pytest.raises(ValueError, match="grammar"):
        ckpt.check_run_name(name)
    assert ckpt.check_run_name("raft-stereo") == "raft-stereo"


def test_load_params_reads_a_reference_pth(tmp_path):
    model, _ = _tiny_state()
    path = tmp_path / "w.pth"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, path)
    other = init_raft_stereo(RAFTStereoConfig(**TINY), seed=9, device="cpu")
    ckpt.load_params(str(path), other)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 other.state_dict().values()))


# -- the trainer ------------------------------------------------------------------------


def _batch(nan=False):
    b = {"image1": torch.zeros(1, 32, 48, 3), "image2": torch.zeros(1, 32, 48, 3),
         "flow": torch.zeros(1, 32, 48, 1), "valid": torch.ones(1, 32, 48)}
    if nan:
        b["image1"][0, 0, 0, 0] = float("nan")
    return b


def test_nan_step_leaves_params_and_adam_state_unchanged():
    model, opt = _tiny_state()
    step = make_train_step(model, opt, 2)
    m = step(_batch())
    assert m["skipped"] == 0.0 and m["finite"] == 1.0
    params = [p.detach().clone() for p in model.parameters()]
    adam = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for st in opt.adamw.state.values() for k, v in st.items()}
    lr = opt.lr
    m = step(_batch(nan=True))
    assert m["finite"] == 0.0 and m["skipped"] == 1.0 and m["notfinite_count"] == 1.0
    assert all(torch.equal(a, b) for a, b in zip(params, model.parameters()))
    after = {k: v for st in opt.adamw.state.values() for k, v in st.items()}
    assert all(torch.equal(adam[k], after[k]) if isinstance(adam[k], torch.Tensor)
               else adam[k] == after[k] for k in adam)
    assert opt.lr == lr and opt.schedule.last_epoch == 1
    assert step(_batch(nan=True))["notfinite_count"] == 2.0
    m = step(_batch())
    assert m["skipped"] == 0.0 and m["notfinite_count"] == 0.0 and m["total_notfinite"] == 2.0
    # optax's rule: past max_consecutive_errors the update is applied anyway
    for _ in range(2):
        assert step(_batch(nan=True))["applied"] == 0.0
    assert step(_batch(nan=True))["applied"] == 1.0


def test_consecutive_nan_steps_abort_at_the_bound(things, tmp_path):
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        _train(things, tmp_path, max_bad_steps=3, faults=FaultPlan(nan_at_steps=(1, 2, 3)))
    steps = _steps(tmp_path)
    assert [s["skipped"] for s in steps] == [0.0, 1.0, 1.0, 1.0]


def test_isolated_nan_is_skipped_and_training_completes(things, tmp_path):
    res = _train(things, tmp_path, max_bad_steps=3, faults=FaultPlan(nan_at_steps=(2,)))
    assert res["skipped_steps"] == 1.0 and res["step"] == 6.0


def test_truncated_newest_checkpoint_falls_back(things, tmp_path):
    _train(things, tmp_path, num_steps=4)
    d = tmp_path / "checkpoints"
    assert sorted(os.listdir(d)) == sorted([f"2_raft-stereo{ckpt.CKPT_SUFFIX}",
                                            f"4_raft-stereo{ckpt.CKPT_SUFFIX}",
                                            f"raft-stereo{ckpt.CKPT_SUFFIX}"])
    os.remove(d / f"raft-stereo{ckpt.CKPT_SUFFIX}")
    truncate_file(str(d / f"4_raft-stereo{ckpt.CKPT_SUFFIX}"))
    again = tmp_path / "again"
    res = train(RAFTStereoConfig(**TINY), _tcfg(restore_ckpt=str(d)), data_root=things,
                validate=False, device="cpu", log_dir=str(again / "runs"))
    assert res["step"] == 6.0
    assert [s["step"] for s in _steps(again)] == [2, 3, 4, 5]


def test_keep_last_k(things, tmp_path):
    _train(things, tmp_path, num_steps=8, keep_ckpts=2)
    left = sorted(os.listdir(tmp_path / "checkpoints"))
    assert left == sorted([f"6_raft-stereo{ckpt.CKPT_SUFFIX}", f"8_raft-stereo{ckpt.CKPT_SUFFIX}",
                           f"raft-stereo{ckpt.CKPT_SUFFIX}"])


def test_resume_equals_the_uninterrupted_run_bit_for_bit(things, tmp_path):
    """A run stopped by SIGTERM at step 3 (a preempt bundle, no final one)
    and relaunched from the directory continues the schedule and the data
    where the uninterrupted run is: the same losses and the same final
    state, bit for bit."""
    full = tmp_path / "full"
    _train(things, full)
    part = tmp_path / "part"
    _train(things, part, faults=FaultPlan(sigterm_at_step=3))
    names = sorted(os.listdir(part / "checkpoints"))
    assert f"3_preempt_raft-stereo{ckpt.CKPT_SUFFIX}" in names
    assert f"raft-stereo{ckpt.CKPT_SUFFIX}" not in names
    res = train(RAFTStereoConfig(**TINY), _tcfg(restore_ckpt=str(part / "checkpoints")),
                data_root=things, validate=False, device="cpu", log_dir=str(part / "runs2"))
    assert res["step"] == 6.0
    a = {s["step"]: s for s in _steps(full)}
    b = [json.loads(line) for line in (part / "runs2" / "steps.jsonl").read_text().splitlines()]
    assert [s["step"] for s in b] == [3, 4, 5]
    assert all(a[s["step"]]["loss"] == s["loss"] for s in b)
    fa, oa, _ = ckpt.load_checkpoint(str(full / "checkpoints" / f"raft-stereo{ckpt.CKPT_SUFFIX}"))
    fb, ob, _ = ckpt.load_checkpoint(str(part / "checkpoints" / f"raft-stereo{ckpt.CKPT_SUFFIX}"))
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert oa["schedule"]["last_epoch"] == ob["schedule"]["last_epoch"] == 6


def test_relaunch_of_a_finished_run_trains_nothing(things, tmp_path):
    _train(things, tmp_path, num_steps=2)
    res = train(RAFTStereoConfig(**TINY), _tcfg(num_steps=2,
                                                 restore_ckpt=str(tmp_path / "checkpoints")),
                data_root=things, validate=False, device="cpu", log_dir=str(tmp_path / "r2"))
    assert res["step"] == 2.0


def test_corrupt_sample_is_quarantined_and_training_completes(things, tmp_path):
    from raft_stereo_tpu_torch.data.loader import fetch_dataloader
    first = int(fetch_dataloader(_tcfg(), root=things)._epoch_order(0)[0])
    res = _train(things, tmp_path, num_steps=3, data_retries=1,
                 faults=FaultPlan(io_errors={first: -1}))
    assert res["quarantined_samples"] == 1.0 and res["step"] == 3.0


class ToyDataset:
    def __init__(self, n=8):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index, rng=None):
        v = rng.standard_normal(4).astype(np.float32) + index
        return {"image1": v, "image2": v, "flow": v[:1], "valid": v[:1]}


def _epochs(loader, n=2):
    return [b["image1"].copy() for _ in range(n) for b in loader]


def test_loader_retry_quarantine_and_substitution():
    def loader(plan=None, n=8):
        ds = ToyDataset(n) if plan is None else FaultyDataset(ToyDataset(n), plan)
        return StereoLoader(ds, batch_size=4, num_workers=2, seed=7, retries=2,
                            retry_backoff=0.001)
    clean = _epochs(loader())
    transient = loader(FaultPlan(io_errors={3: 1}))
    assert all((a == b).all() for a, b in zip(clean, _epochs(transient)))
    assert transient.quarantine_report() == {}
    bad = loader(FaultPlan(io_errors={3: -1}))
    run1 = _epochs(bad)
    assert list(bad.quarantine_report()) == [3]
    run2 = _epochs(loader(FaultPlan(io_errors={3: -1})))
    assert all((a == b).all() for a, b in zip(run1, run2))
    with pytest.raises(RuntimeError, match="substitute"):
        _epochs(loader(FaultPlan(io_errors={i: -1 for i in range(8)})), n=1)


def test_multi_card_work_raises_before_the_model():
    """What a single process cannot run stops train() before it builds the
    model: a space axis wider than the world (the JAX package's message),
    and a multi-process launch whose topology is incomplete."""
    with pytest.raises(ValueError, match="does not divide the 1 available device"):
        train(RAFTStereoConfig(**TINY), TrainConfig(spatial_shard=2), device="cpu")
    os.environ["COORDINATOR_ADDRESS"] = "localhost:1234"
    try:
        with pytest.raises(RuntimeError, match="set all three"):
            train(RAFTStereoConfig(**TINY), TrainConfig(), device="cpu")
        os.environ["PROCESS_ID"] = "0"
        with pytest.raises(RuntimeError, match="must be set together"):
            train(RAFTStereoConfig(**TINY), TrainConfig(), device="cpu")
    finally:
        del os.environ["COORDINATOR_ADDRESS"]
        os.environ.pop("PROCESS_ID", None)
