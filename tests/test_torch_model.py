"""The port's model (raft_stereo_tpu_torch) as a whole, on the CPU.

- Weights: ``params_from_jax`` reproduces the JAX package's
  ``export_state_dict`` key for key and value for value, and loads strictly.
- Test-mode forward at 128x256 (so all three GRU levels have >= 8 rows and
  the JAX package engages its kernels), hidden dims 32, 3 iterations, with
  the flow head's last conv scaled by 1/50 (``_temper``: at random init it
  moves the coordinates ~35 px an iteration, which sends the lookups off the
  rows and makes the loop chaotic, so that even the JAX package's own bf16
  kernel and XLA paths then differ by pixels):
  the fp32 port against JAX ``reg`` in fp32 (summation order only, 1e-4 px),
  and the bf16 port (``reg_cuda``, plain versions of the kernels) against
  JAX ``reg_tpu`` in bf16 with its lookup, motion and GRU kernels engaged,
  within the serving canary band (rtol 5e-3, atol 5e-2 px).
- The port's own identities, bitwise: k segments == one loop, and
  ``epilogue(segment_carry(s)) == segment(s)``.
- Carry composition for serving: ``stack_refinement_states`` and
  ``take_refinement_rows`` give the JAX package's helpers' values on the
  same carry (fp32 and a ``Lane8`` carry, rows in order, a row repeated),
  and a stacked carry's rows advance as the carries alone (fp32, 1e-4 px: the CPU convs
  sum a batch in another order).
- The port imports without jax and imports nothing of the JAX package; its
  entry points refuse to run without CUDA unless asked for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raft_stereo_tpu.corr.pallas_reg as jx_pallas_reg
import raft_stereo_tpu.ops.pallas_stream as jx_ps
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import init_raft_stereo as jx_init
from raft_stereo_tpu.models import raft_stereo_forward as jx_forward
from raft_stereo_tpu.models.raft_stereo import stack_refinement_states as jx_stack
from raft_stereo_tpu.models.raft_stereo import take_refinement_rows as jx_take
from raft_stereo_tpu.transplant.torch_loader import export_state_dict

import raft_stereo_tpu_torch.models.raft_stereo as port_model
from raft_stereo_tpu_torch import (
    RAFTStereo, RAFTStereoConfig, init_raft_stereo, raft_stereo_epilogue,
    raft_stereo_forward, raft_stereo_inference, raft_stereo_prepare, raft_stereo_segment,
    raft_stereo_segment_carry, with_eval_precision)
from raft_stereo_tpu_torch.corr.reg_cuda import Lane8
from raft_stereo_tpu_torch.models import stack_refinement_states, take_refinement_rows
from raft_stereo_tpu_torch.transplant import load_state_dict, params_from_jax

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(hidden_dims=(32, 32, 32))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The parallel test runner puts several worker processes on one CPU;
    a small intra-op pool keeps these tests from starving the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jx_forward_jit(cfg, iters: int):
    """The JAX package's test-mode forward, jitted: traced once (kernel
    calls counted at the trace, as eagerly) and on the CPU about twice as
    fast as its eager interpreter."""
    return jax.jit(lambda p, a, b, flow_init=None: jx_forward(
        p, cfg, a, b, iters=iters, test_mode=True, flow_init=flow_init))




def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _port_from_jax(params, cfg_kw) -> RAFTStereo:
    cfg = RAFTStereoConfig(**cfg_kw)
    model = RAFTStereo(cfg)
    load_state_dict(model, params_from_jax(_np_tree(params), cfg))
    return model.eval()


def _temper(params):
    """Scale the flow head's last conv by 1/50, so an iteration moves the
    coordinates by under a pixel or so, as a trained model's does."""
    conv2 = params["update_block"]["flow_head"]["conv2"]
    conv2["w"], conv2["b"] = conv2["w"] * 0.02, conv2["b"] * 0.02
    return params


def _images(rng, h, w, b=1):
    return [rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("cfg_kw", [SMALL, dict(shared_backbone=True, n_gru_layers=2,
                                                n_downsample=3)])
def test_params_from_jax_matches_export_state_dict(cfg_kw):
    jcfg = JaxConfig(**cfg_kw)
    params = jx_init(jax.random.PRNGKey(0), jcfg)
    ref = export_state_dict(params, jcfg, module_prefix=False)
    got = params_from_jax(_np_tree(params), RAFTStereoConfig(**cfg_kw))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    model = RAFTStereo(RAFTStereoConfig(**cfg_kw))
    assert sorted(model.state_dict()) == sorted(ref)
    load_state_dict(model, {f"module.{k}": v for k, v in got.items()})  # strict


def test_fp32_forward_matches_jax_reg(rng):
    params = _temper(jx_init(jax.random.PRNGKey(1), JaxConfig(**SMALL)))
    i1, i2 = _images(rng, 128, 256)
    ref_lo, ref_up = _jx_forward_jit(JaxConfig(**SMALL), 3)(params, jnp.asarray(i1),
                                                            jnp.asarray(i2))
    model = _port_from_jax(params, SMALL)
    lo, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    assert lo.shape == (1, 32, 64, 2) and up.shape == (1, 128, 256, 1)
    np.testing.assert_allclose(lo.numpy(), np.asarray(ref_lo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref_up), rtol=0, atol=1e-4)


def test_bf16_forward_matches_jax_reg_tpu_kernels(rng, monkeypatch):
    """JAX runs the slice's serial kernel chain: _lookup_kernel,
    _motion_kernel and _gru_kernel (+FlowHead), with the encoder kernels,
    the gru16+32 co-schedule and the resident iteration switched off."""
    for knob in ("RAFT_FUSED_ENCODERS", "RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        monkeypatch.setenv(knob, "0")
    calls = {"lookup": 0, "motion": 0, "gru": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jx_pallas_reg, "_pallas_lookup",
                        counting("lookup", jx_pallas_reg._pallas_lookup))
    monkeypatch.setattr(jx_ps, "fused_motion_fwd_impl",
                        counting("motion", jx_ps.fused_motion_fwd_impl))
    monkeypatch.setattr(jx_ps, "fused_conv_gru_fwd_impl",
                        counting("gru", jx_ps.fused_conv_gru_fwd_impl))
    kw = dict(SMALL, corr_implementation="reg_tpu", mixed_precision=True)
    params = _temper(jx_init(jax.random.PRNGKey(2), JaxConfig(**kw)))
    i1, i2 = _images(rng, 128, 256)
    ref_lo, ref_up = _jx_forward_jit(JaxConfig(**kw), 3)(params, jnp.asarray(i1),
                                                         jnp.asarray(i2))
    # The scan body traces each kernel site once; the three GRU levels are
    # three sites.
    assert calls == {"lookup": 1, "motion": 1, "gru": 3}, calls
    model = _port_from_jax(params, dict(kw, corr_implementation="reg_cuda"))
    lo, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref_up, np.float32),
                               rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(lo.numpy(), np.asarray(ref_lo, np.float32),
                               rtol=5e-3, atol=5e-2)


@pytest.mark.parametrize("mixed", [False, True])
def test_segments_and_epilogue_are_bitwise_identities(rng, mixed):
    cfg = RAFTStereoConfig(**SMALL, corr_implementation="reg_cuda", mixed_precision=mixed)
    model = init_raft_stereo(cfg, seed=3, device="cpu")
    i1, i2 = (torch.from_numpy(a) for a in _images(rng, 64, 128))
    one = raft_stereo_inference(model, i1, i2, iters=4, segments=1)
    two = raft_stereo_inference(model, i1, i2, iters=4, segments=2)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    state = raft_stereo_prepare(model, i1, i2)
    _, lo, up = raft_stereo_segment(model, state, iters=2)
    carried, dnorm = raft_stereo_segment_carry(model, state, iters=2)
    lo2, up2 = raft_stereo_epilogue(model, carried)
    assert torch.equal(lo, lo2) and torch.equal(up, up2)
    assert dnorm.shape == (1,) and dnorm.dtype == torch.float32
    expect = (carried["coords1"] - state["coords1"])[..., 0].abs().mean() / 2
    assert torch.equal(dnorm[0], expect)


@pytest.mark.parametrize("mixed", [False, True])
def test_flow_init_runs_the_plain_motion_encoder(rng, monkeypatch, mixed):
    """A caller-supplied flow_init keeps the motion encoder off the kernel
    (its flow-y weights matter then), in JAX and in the port; fp32 against
    JAX ``reg`` to 1e-4 px, bf16 (the GRU kernels' plain versions) against
    JAX ``reg_tpu`` with its GRU kernels within the canary band."""
    for knob in ("RAFT_FUSED_ENCODERS", "RAFT_FUSE_GRU1632", "RAFT_FUSE_ITER"):
        monkeypatch.setenv(knob, "0")
    kw = dict(SMALL, corr_implementation="reg_tpu", mixed_precision=True) if mixed else SMALL
    params = _temper(jx_init(jax.random.PRNGKey(4), JaxConfig(**kw)))
    i1, i2 = _images(rng, 64, 128)
    init = rng.standard_normal((1, 16, 32, 2)).astype(np.float32)
    _, ref_up = _jx_forward_jit(JaxConfig(**kw), 2)(params, jnp.asarray(i1), jnp.asarray(i2),
                                                    jnp.asarray(init))
    model = _port_from_jax(params, dict(kw, corr_implementation="reg_cuda") if mixed else kw)
    _, up = raft_stereo_forward(model, torch.from_numpy(i1), torch.from_numpy(i2),
                                iters=2, flow_init=torch.from_numpy(init))
    ref_up = np.asarray(ref_up, np.float32)
    if mixed:
        np.testing.assert_allclose(up.numpy(), ref_up, rtol=5e-3, atol=5e-2)
    else:
        np.testing.assert_allclose(up.numpy(), ref_up, rtol=0, atol=1e-4)


def test_sequential_fnet_matches_batched(rng, monkeypatch):
    cfg = RAFTStereoConfig(**SMALL)
    model = init_raft_stereo(cfg, seed=5, device="cpu")
    i1, i2 = (torch.from_numpy(a) for a in _images(rng, 64, 96))
    batched = raft_stereo_forward(model, i1, i2, iters=1)
    monkeypatch.setattr(port_model, "FNET_SEQUENTIAL_MIN_PIXELS", 0)
    sequential = raft_stereo_forward(model, i1, i2, iters=1)
    for a, b in zip(batched, sequential):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


def _leaves(tree) -> list:
    """The carry's tensor leaves in a fixed order, as fp32 numpy arrays."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree.float() if isinstance(tree, torch.Tensor) else tree, np.float32)]


def _as_jax(tree):
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_as_jax(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("lane", [False, True])
def test_carry_stack_and_take_match_jax(rng, monkeypatch, lane):
    """Two carries (the second a batch of 2) stacked, then rows taken out of
    order with a repeat: the JAX package's helpers on the same values give
    the same values. Under RAFT_LANE_PACK8 the carry holds Lane8 containers,
    which stack and take by their batch rows, q and scale alike."""
    monkeypatch.setenv("RAFT_LANE_PACK8", "1" if lane else "0")
    kw = dict(SMALL, corr_implementation="reg_cuda", mixed_precision=True) if lane else SMALL
    model = init_raft_stereo(RAFTStereoConfig(**kw), seed=7, device="cpu")
    one = raft_stereo_prepare(model, *(torch.from_numpy(a) for a in _images(rng, 64, 96)))
    two = raft_stereo_prepare(model, *(torch.from_numpy(a) for a in _images(rng, 64, 96, b=2)))
    assert isinstance(one["fmap1"], Lane8) == lane
    stacked = stack_refinement_states([one, two])
    assert stacked["coords1"].shape[0] == 3
    rows = [2, 0, 2, 1]
    taken = take_refinement_rows(stacked, rows)
    if lane:
        assert isinstance(taken["inp"][0], Lane8) and taken["inp"][0].scale.shape == (4,)
        assert taken["fmap1"].q.dtype == torch.int8
    ref_stacked = jx_stack([_as_jax(one), _as_jax(two)])
    ref_taken = jx_take(ref_stacked, rows)
    for got, ref in ((stacked, ref_stacked), (taken, ref_taken)):
        got_leaves, ref_leaves = _leaves(got), _leaves(ref)
        assert len(got_leaves) == len(ref_leaves)
        for a, b in zip(got_leaves, ref_leaves):
            np.testing.assert_array_equal(a, b)
    assert stack_refinement_states([one]) is one
    with pytest.raises(ValueError):
        stack_refinement_states([])


def test_stacked_carry_rows_advance_as_alone(rng):
    model = init_raft_stereo(RAFTStereoConfig(**SMALL), seed=8, device="cpu")
    states = [raft_stereo_prepare(model, *(torch.from_numpy(a) for a in _images(rng, 64, 96)))
              for _ in range(2)]
    stacked, _ = raft_stereo_segment_carry(model, stack_refinement_states(states), iters=2)
    for i, state in enumerate(states):
        alone, _ = raft_stereo_segment_carry(model, state, iters=2)
        row = take_refinement_rows(stacked, [i])
        np.testing.assert_allclose(row["coords1"].numpy(), alone["coords1"].numpy(),
                                   rtol=0, atol=1e-4)


def test_config_choices():
    assert RAFTStereoConfig(corr_implementation="reg_tpu").corr_kind == "reg_cuda"
    assert with_eval_precision(RAFTStereoConfig(corr_implementation="reg_cuda")).mixed_precision
    for impl, kind in (("alt", "alt"), ("alt_cuda", "alt_cuda"), ("alt_tpu", "alt_cuda")):
        assert RAFTStereoConfig(corr_implementation=impl).corr_kind == kind
    assert with_eval_precision(RAFTStereoConfig(corr_implementation="alt_tpu")).mixed_precision
    assert not with_eval_precision(RAFTStereoConfig(corr_implementation="alt")).mixed_precision
    assert RAFTStereoConfig(slow_fast_gru=True).slow_fast_gru
    # Train mode: the per-iteration
    # upsampled predictions.
    preds = RAFTStereo(RAFTStereoConfig(**SMALL))(torch.zeros(1, 32, 32, 3),
                                                  torch.zeros(1, 32, 32, 3), iters=2)
    assert preds.shape == (2, 1, 32, 32, 1) and preds.grad_fn is not None


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_raft_stereo(RAFTStereoConfig(**SMALL))
    assert next(init_raft_stereo(RAFTStereoConfig(**SMALL), device="cpu")
                .parameters()).device.type == "cpu"


def test_demo_cli_on_cpu(tmp_path, rng):
    """The demo CLI end to end: a .pth from JAX weights, two PNG pairs."""
    from PIL import Image

    from raft_stereo_tpu_torch import demo
    params = jx_init(jax.random.PRNGKey(6), JaxConfig(**SMALL))
    sd = params_from_jax(_np_tree(params), RAFTStereoConfig(**SMALL))
    torch.save({f"module.{k}": v for k, v in sd.items()}, tmp_path / "w.pth")
    for scene in ("a", "b"):
        (tmp_path / scene).mkdir()
        for name in ("im0.png", "im1.png"):
            Image.fromarray(rng.integers(0, 255, (40, 70, 3), dtype=np.uint8)).save(
                tmp_path / scene / name)
    out = tmp_path / "out"
    demo.main(["--restore_ckpt", str(tmp_path / "w.pth"), "-l", str(tmp_path / "*/im0.png"),
               "-r", str(tmp_path / "*/im1.png"), "--output_directory", str(out),
               "--valid_iters", "2", "--hidden_dims", "32", "32", "32", "--save_numpy",
               "--corr_implementation", "reg_cuda", "--device", "cpu"])
    for scene in ("a", "b"):
        disp = np.load(out / f"{scene}.npy")
        assert disp.shape == (40, 70) and np.isfinite(disp).all()
        assert (out / f"{scene}.png").exists()


def _port_files():
    return sorted((REPO / "raft_stereo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "raft_stereo_tpu"), (path, name)


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['raft_stereo_tpu'] = None\n"
            "import raft_stereo_tpu_torch, raft_stereo_tpu_torch.demo, "
            "raft_stereo_tpu_torch.transplant, raft_stereo_tpu_torch.corr.reg_cuda, "
            "raft_stereo_tpu_torch.ops.stream, raft_stereo_tpu_torch.ops.resident, "
            "raft_stereo_tpu_torch.ops.encoder, raft_stereo_tpu_torch.kernels, "
            "raft_stereo_tpu_torch.bench, raft_stereo_tpu_torch.obs.ledger, "
            "raft_stereo_tpu_torch.obs.profiler, "
            "raft_stereo_tpu_torch.faults, raft_stereo_tpu_torch.analysis.knobs, "
            "raft_stereo_tpu_torch.serve, raft_stereo_tpu_torch.serve.session, "
            "raft_stereo_tpu_torch.serve.degrade, raft_stereo_tpu_torch.serve.heal, "
            "raft_stereo_tpu_torch.obs.tracing, raft_stereo_tpu_torch.obs.flight, "
            "raft_stereo_tpu_torch.obs.deck, raft_stereo_tpu_torch.obs.capacity, "
            "raft_stereo_tpu_torch.obs.usage, "
            "raft_stereo_tpu_torch.serve.scheduler, raft_stereo_tpu_torch.serve.service, "
            "raft_stereo_tpu_torch.serve.supervise, raft_stereo_tpu_torch.serve.wire, "
            "raft_stereo_tpu_torch.serve.http, raft_stereo_tpu_torch.data.frame_utils, "
            "raft_stereo_tpu_torch.serve_stereo, "
            "raft_stereo_tpu_torch.serve.stream, raft_stereo_tpu_torch.serve.cache, "
            "raft_stereo_tpu_torch.serve.fleet, raft_stereo_tpu_torch.obs.fleet, "
            "raft_stereo_tpu_torch.fleet_stereo, "
            "raft_stereo_tpu_torch.ops.grad, raft_stereo_tpu_torch.engine, "
            "raft_stereo_tpu_torch.engine.train, raft_stereo_tpu_torch.engine.evaluate, "
            "raft_stereo_tpu_torch.engine.checkpoint, raft_stereo_tpu_torch.engine.steps, "
            "raft_stereo_tpu_torch.data.loader, raft_stereo_tpu_torch.data.datasets, "
            "raft_stereo_tpu_torch.data.augmentor, raft_stereo_tpu_torch.data.photometric, "
            "raft_stereo_tpu_torch.data.synthetic, "
            "raft_stereo_tpu_torch.train_stereo, raft_stereo_tpu_torch.evaluate_stereo, "
            "chip_smoke\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
