"""The port's height sharding (``raft_stereo_tpu_torch/parallel/``,
``ops/halo.py``, the spatial entries of ``ops/stream.py``, the sharded
model) on the CPU, in real processes over gloo (``tests/torch_ranks.py``),
against the JAX package.

Two launches run while this process computes the references:
- 4 ranks (``halo``): the halo exchange as one 4-way space row and as two
  2-way rows, forward (equal to slicing the zero-padded whole map) and
  backward in fp64 (equal to the exchange's transpose, the scatter-add of
  each rank's halo gradient onto the rows it came from, and the adjoint
  identity over the ranks); the sharded align-corners resize and pool2x,
  bit for bit the unsharded ones on the gathered rows, fp32 and bf16; one
  train step on the (2, 2) grid (data and space at once) against the
  port's one-process step on the same global batch (the (2, 1) and (1, 2)
  steps are held to the JAX package's in test_torch_multihost.py).
- 2 ranks (``ns2``): each spatial entry (conv_gru, conv_gru with the
  FlowHead, motion) at ``ns = 2`` against the JAX package's unsharded
  ``fused_conv_gru`` / ``fused_gru_head`` / ``fused_motion`` (fp32 through
  its test hook ``FORCE_FUSABLE_DTYPE``, and bf16; each jitted once, with
  its vjp) and against the port's unsharded entry, outputs (fp32 within
  1e-4 of the scale, ``_bound``; bf16 in the canary band,
  ``serve/guard.py``: rtol 5e-3, atol 5e-2) and per-leaf gradients; the sharded test-mode forward,
  fp32 within 1e-4 px of JAX's unsharded forward and bf16 (the spatial
  entries engaged, their calls counted) in the canary band of the port's
  unsharded forward.

Weights: the port's seeded model (the flow head tempered as in
``test_torch_train.py``) carried into JAX with ``transplant_state_dict``
(the repo's practice: the JAX package's eager init takes ~17 s on the CPU);
the entries' modules from the JAX package's seeded layer inits through
``transplant._conv``. ``choose_mesh`` and ``validate_spatial_shard`` are
held to the JAX package's topologies and messages. The grid train steps
and the multi-process pod are in test_torch_multihost.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raft_stereo_tpu.ops.pallas_stream as ps
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import raft_stereo_forward as jx_forward
from raft_stereo_tpu.models import update as jx_update

from raft_stereo_tpu_torch import transplant
from raft_stereo_tpu_torch.models import raft_stereo_forward
from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
from raft_stereo_tpu_torch.ops.pooling import pool2x
from raft_stereo_tpu_torch.ops.resize import interp_align_corners
from raft_stereo_tpu_torch.parallel import MeshShape, choose_mesh, validate_spatial_shard
from raft_stereo_tpu_torch.serve.guard import CANARY_ATOL, CANARY_RTOL
from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
from raft_stereo_tpu_torch.engine.steps import make_train_step
from tests.test_torch_train import port_model
from tests.torch_ranks import (GRID_GRAD_BAND, TRAIN, TRAIN_ITERS, TRAIN_OPT, launch,
                               train_batch, unsharded_entries)

EVAL = dict(hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
EVAL_ITERS = 2
HALO_KS = {4: (1, 3), 2: (1, 5)}
RESIZE = {"a": (8, 16, 5, 9), "b": (16, 32, 6, 6), "c": (24, 48, 4, 8)}
POOL_HEIGHTS = (8, 16, 24)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _load(module, fill):
    out = {}
    fill(out)
    module.load_state_dict({k[2:]: v for k, v in out.items()}, strict=True)
    return module


def _entry_inputs(inp):
    rng = np.random.default_rng(9)
    b, h, w, ch, parts, nh = 2, 32, 20, 32, (32, 32), 64
    p = jx_update.init_conv_gru(jax.random.PRNGKey(0), ch, sum(parts))
    hp = jx_update.init_flow_head(jax.random.PRNGKey(1), ch, nh, 2)
    jcfg = JaxConfig()
    pm = jx_update.init_motion_encoder(jax.random.PRNGKey(2), jcfg)
    inp.update(
        gru_dims=(ch, sum(parts)), head_nh=nh, cor_planes=jcfg.cor_planes,
        gru_sd=_load(ConvGRU(ch, sum(parts)), lambda o: [
            transplant._conv(o, f"m.{g}", p[g]) for g in ("convz", "convr", "convq")]
        ).state_dict(),
        head_sd=_load(FlowHead(ch, nh, 2), lambda o: [
            transplant._conv(o, f"m.{c}", hp[c]) for c in ("conv1", "conv2")]).state_dict(),
        motion_sd=_load(BasicMotionEncoder(jcfg.cor_planes), lambda o: [
            transplant._conv(o, f"m.{c}", pm[c])
            for c in ("convc1", "convc2", "convf1", "convf2", "conv")]).state_dict(),
        gru_h=(rng.standard_normal((b, h, w, ch)) * 0.5).astype(np.float32),
        gru_xs=[rng.standard_normal((b, h, w, c)).astype(np.float32) for c in parts],
        gru_ctx=[(rng.standard_normal((b, h, w, ch)) * 0.3).astype(np.float32)
                 for _ in range(3)],
        cot_h=rng.standard_normal((b, h, w, ch)).astype(np.float32),
        cot_dx=rng.standard_normal((b, h, w, 1)).astype(np.float32),
        motion_corr=rng.standard_normal((b, h, w, jcfg.cor_planes)).astype(np.float32),
        motion_flow=np.concatenate([rng.standard_normal((b, h, w, 1)) * 3,
                                    np.zeros((b, h, w, 1))], -1).astype(np.float32),
        cot_motion=rng.standard_normal((b, h, w, 128)).astype(np.float32))
    return p, hp, pm


def _inputs():
    """Everything the ranks read, and the JAX layer parameters of the
    entries."""
    rng = np.random.default_rng(3)
    inp = {"halo_x": rng.standard_normal((2, 16, 5, 3)), "halo_ks": HALO_KS,
           "resize_cases": RESIZE, "pool_heights": POOL_HEIGHTS, "eval_iters": EVAL_ITERS}
    for ns, ks in HALO_KS.items():
        for k in ks:
            inp[f"halo_cot_{ns}_{k}"] = rng.standard_normal((ns, 2, 16 // ns + 2 * k, 5, 3))
    for name, (hin, _, w_in, _) in RESIZE.items():
        inp[f"resize_{name}"] = rng.standard_normal((2, hin, w_in, 3)).astype(np.float32)
    for h in POOL_HEIGHTS:
        inp[f"pool_{h}"] = rng.standard_normal((2, h, 7, 4)).astype(np.float32)
    jparams = _entry_inputs(inp)
    inp.update(train_cfg=TRAIN, train_sd=port_model(TRAIN, seed=1).state_dict(),
               train_iters=TRAIN_ITERS, train_opt=TRAIN_OPT)
    eval_model = port_model(EVAL, seed=2).eval()
    for key, kw, h in (("eval_fp32", EVAL, 64), ("eval_bf16", dict(
            EVAL, mixed_precision=True, corr_implementation="reg_cuda"), 128)):
        inp[f"{key}_cfg"] = kw
        inp[f"{key}_sd"] = eval_model.state_dict()
        inp[f"{key}_image1"] = rng.uniform(0, 255, (1, h, 64, 3)).astype(np.float32)
        inp[f"{key}_image2"] = rng.uniform(0, 255, (1, h, 64, 3)).astype(np.float32)
    return inp, jparams, eval_model


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both launches, and the references computed while they run."""
    d = tmp_path_factory.mktemp("ranks")
    inp, (p, hp, pm), eval_model = _inputs()
    torch.save(inp, d / "inputs.pt")
    wait_ns2 = launch("ns2", 2, d, d / "ns2")
    wait_halo = launch("halo", 4, d, d / "halo")
    try:
        refs = {"entries": _jax_entries(inp, p, hp, pm),
                "port_entries": unsharded_entries(inp), "train": _one_process_step(),
                "eval": _eval_refs(inp, eval_model)}
        yield inp, refs, wait_ns2(), wait_halo()
    finally:
        # Leave no rank running behind a failure.
        for q in [*wait_ns2.procs, *wait_halo.procs]:
            if q.poll() is None:
                q.kill()
                q.wait()


# -- references ------------------------------------------------------------------


def _jax_entries(inp, p, hp, pm):
    """JAX's unsharded entries: outputs and, for the same cotangents, the
    gradients (its XLA oracles), in the port's names."""
    out = {}
    old = ps.FORCE_FUSABLE_DTYPE
    ps.FORCE_FUSABLE_DTYPE = True
    try:
        for kind, jdt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
            j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
            h, xs, ctx = j(inp["gru_h"]), [j(x) for x in inp["gru_xs"]], \
                [j(c) for c in inp["gru_ctx"]]
            for head in (False, True):
                def fn(p, hp, h, ctx, xs, head=head):
                    czrq = ps.prepare_gru_context(p, ctx, jdt)
                    if head:
                        return ps.fused_gru_head(p, hp, h, czrq, ctx, *xs)
                    return ps.fused_conv_gru(p, h, czrq, ctx, *xs)
                def with_vjp(p, hp, h, ctx, xs, cot, fn=fn):
                    res, vjp = jax.vjp(fn, p, hp, h, ctx, xs)
                    return res, vjp(cot)

                cot_h = jnp.asarray(inp["cot_h"], jdt)
                cot = (cot_h, jnp.asarray(inp["cot_dx"])) if head else cot_h
                res, (gp, ghp, gh, gctx, gxs) = jax.jit(with_vjp)(p, hp, h, ctx, xs, cot)
                pg = {}
                for name in ("convz", "convr", "convq"):
                    transplant._conv(pg, f"gru.{name}", jax.tree_util.tree_map(np.asarray,
                                                                               gp[name]))
                if head:
                    for name in ("conv1", "conv2"):
                        transplant._conv(pg, f"head.{name}", jax.tree_util.tree_map(
                            np.asarray, ghp[name]))
                tag = f"{'gru_head' if head else 'gru'}_{kind}"
                out[f"{tag}_h"] = _np(res[0] if head else res)
                if head:
                    out[f"{tag}_dx"] = _np(res[1])
                out[f"{tag}_pgrads"] = {k: _np(v) for k, v in pg.items()}
                out[f"{tag}_igrads"] = {"h": _np(gh), **{f"x{i}": _np(x) for i, x in
                                                         enumerate(gxs)},
                                        **{f"c{i}": _np(c) for i, c in enumerate(gctx)}}
            flow, corr = j(inp["motion_flow"]), j(inp["motion_corr"])
            def motion_vjp(pm, flow, corr, cot):
                res, vjp = jax.vjp(ps.fused_motion, pm, flow, corr)
                return res, vjp(cot)

            res, (gpm, _, gcorr) = jax.jit(motion_vjp)(pm, flow, corr,
                                                       jnp.asarray(inp["cot_motion"], jdt))
            pg = {}
            for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
                transplant._conv(pg, name, jax.tree_util.tree_map(np.asarray, gpm[name]))
            out[f"motion_{kind}"] = _np(res)
            out[f"motion_{kind}_pgrads"] = {k: _np(v) for k, v in pg.items()}
            out[f"motion_{kind}_igrads"] = {"corr": _np(gcorr)}
    finally:
        ps.FORCE_FUSABLE_DTYPE = old
    return out


def _one_process_step() -> dict:
    """The port's train step on the global batch in this one process."""
    model = port_model(TRAIN, seed=1)
    step = make_train_step(model, make_optimizer(model, *TRAIN_OPT, skip_nonfinite=3),
                           TRAIN_ITERS)
    host = step({k: torch.from_numpy(v) for k, v in train_batch().items()})
    return {"host": host, "params": {n: _np(q) for n, q in model.named_parameters()},
            "grads": {n: _np(q.grad) for n, q in model.named_parameters()
                      if q.grad is not None}}


def _eval_refs(inp, model):
    """JAX's unsharded forward (fp32) and the port's (bf16)."""
    out = {}
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    from raft_stereo_tpu.transplant.torch_loader import transplant_state_dict
    jcfg = JaxConfig(**EVAL)
    params = jax.tree_util.tree_map(jnp.asarray, transplant_state_dict(sd, jcfg))
    fwd = jax.jit(lambda p, a, b: jx_forward(p, jcfg, a, b, iters=EVAL_ITERS,
                                             test_mode=True)[1])
    out["eval_fp32"] = _np(fwd(params, inp["eval_fp32_image1"], inp["eval_fp32_image2"]))
    bf16 = port_model(inp["eval_bf16_cfg"]).eval()
    bf16.load_state_dict(model.state_dict())
    _, up = raft_stereo_forward(bf16, torch.from_numpy(inp["eval_bf16_image1"]),
                                torch.from_numpy(inp["eval_bf16_image2"]), iters=EVAL_ITERS)
    out["eval_bf16"] = _np(up)
    return out


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


# -- topology --------------------------------------------------------------------


def test_choose_mesh_topologies():
    """The JAX package's topologies and messages (tests/test_parallel.py)."""
    dev = list(range(8))
    assert choose_mesh(8, 1, dev, 1) == MeshShape(8, 1)
    assert choose_mesh(2, 4, dev, 1) == MeshShape(2, 4)
    assert choose_mesh(6, 1, dev, 1) == MeshShape(6, 1)
    assert choose_mesh(1, 1, dev[:1], 1) is None
    assert choose_mesh(8, 1, dev, 2) == MeshShape(8, 1)
    assert choose_mesh(2, 4, dev, 2, local_device_count=4) == MeshShape(2, 4)
    assert choose_mesh(4, 2, 4, 4) == MeshShape(2, 2)
    with pytest.raises(ValueError, match="divide 32"):
        choose_mesh(8, 3, dev[:6], 1)
    with pytest.raises(ValueError, match="does not divide"):
        choose_mesh(8, 16, dev, 1)
    with pytest.raises(ValueError, match="divide evenly"):
        choose_mesh(5, 1, dev, 2)
    with pytest.raises(ValueError, match="ICI"):
        choose_mesh(1, 8, dev, 2, local_device_count=4)
    with pytest.raises(ValueError, match="spatial_shard 2 does not divide the 1 available"):
        validate_spatial_shard(2, 1)
    validate_spatial_shard(1, 1)


# -- the halo exchange, the sharded resize and pool -------------------------------


@pytest.mark.parametrize("ns", [2, 4])
def test_halo_exchange_is_the_sliced_map_and_its_backward_the_transpose(run, ns):
    inp, _, _, halo = run
    x = inp["halo_x"]
    b, h, w, c = x.shape
    hl = h // ns
    for k in HALO_KS[ns]:
        padded = np.pad(x, ((0, 0), (k, k), (0, 0), (0, 0)))
        # ns = 2: the first space row of the (2, 2) grid, ranks 0 and 1.
        ranks = halo[:ns]
        transpose = np.zeros_like(padded)
        dot_out = dot_in = 0.0
        for s, r in enumerate(ranks):
            ext = r[f"halo_{ns}_{k}_ext"]
            np.testing.assert_array_equal(ext, padded[:, s * hl:s * hl + hl + 2 * k])
            cot = inp[f"halo_cot_{ns}_{k}"][s]
            transpose[:, s * hl:s * hl + hl + 2 * k] += cot
            dot_out += float(np.sum(ext * cot))
            dot_in += float(np.sum(x[:, s * hl:(s + 1) * hl] * r[f"halo_{ns}_{k}_grad"]))
        for s, r in enumerate(ranks):
            np.testing.assert_allclose(r[f"halo_{ns}_{k}_grad"],
                                       transpose[:, k + s * hl:k + (s + 1) * hl],
                                       rtol=0, atol=1e-12)
        assert abs(dot_out - dot_in) <= 1e-10 * max(1.0, abs(dot_out))
    # The other space row of the (2, 2) grid exchanged on its own.
    if ns == 2:
        for k in HALO_KS[2]:
            np.testing.assert_array_equal(halo[2][f"halo_2_{k}_ext"], halo[0][f"halo_2_{k}_ext"])


@pytest.mark.parametrize("ns", [2, 4])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_sharded_resize_and_pool_are_bitwise_the_unsharded(run, ns, dt):
    inp, _, _, halo = run
    ranks = halo if ns == 4 else halo[:2]
    for name, (hin, hout, _, w_out) in RESIZE.items():
        ref = _np(interp_align_corners(torch.from_numpy(inp[f"resize_{name}"]).to(dt),
                                       (hout, w_out)))
        np.testing.assert_array_equal(_gathered(ranks, f"resize_{ns}_{name}_{dt}"), ref)
    for h in POOL_HEIGHTS:
        ref = _np(pool2x(torch.from_numpy(inp[f"pool_{h}"]).to(dt)))
        np.testing.assert_array_equal(_gathered(ranks, f"pool_{ns}_{h}_{dt}"), ref)


# -- the spatial entries ------------------------------------------------------------

# bf16 gradient bands: the per-leaf relative L2 of a bf16 gradient, the
# denominator floored at 1e-2 of the largest leaf's norm (test_torch_train.py's
# rule), each twice the largest reading on the CPU:
# - the spatial entry against the port's unsharded entry: largest 0.0032
#   (gru_head's parameters; convolutions over the extended rows sum in
#   another order, which moves a few bf16 roundings);
# - against JAX's unsharded entry: largest 0.088 (motion's parameters), the
#   port's unsharded entry reading the same against JAX (0.088): the two
#   packages' bf16 plain formulations, not the sharding.
BF16_GRAD_BAND = {"port": 0.0064, "jax": 0.18}


def _bound(ref: np.ndarray, kind: str) -> np.ndarray:
    """fp32: 1e-4 of the output's scale (most runs read 1.5e-6 of it; one
    run under load read 4.1e-5, summation order moving with the threads);
    bf16: the canary band."""
    if kind == "fp32":
        return np.full(ref.shape, 1e-4 * max(1.0, float(np.abs(ref).max())))
    return CANARY_ATOL + CANARY_RTOL * np.abs(ref)


def _check_grads(got: dict, ref: dict, kind: str, what: str, band: float = 0.0) -> float:
    # The head's x delta leaves out conv2.b[0] (its caller adds it): JAX's
    # gradient of that bias is zero, and the port's entry has none.
    assert set(got) <= set(ref), (what, sorted(got), sorted(ref))
    assert all(not np.abs(ref[n]).max() for n in set(ref) - set(got)), what
    worst = 0.0
    if kind == "fp32":
        for n, g in got.items():
            tol = 1e-4 * float(np.abs(ref[n]).max()) + 1e-6
            d = float(np.abs(g - ref[n]).max())
            assert d <= tol, (what, n, d, tol)
            worst = max(worst, d / tol)
        return worst
    floor = 1e-2 * max(float(np.linalg.norm(g)) for g in ref.values())
    for n, g in got.items():
        rel = float(np.linalg.norm(g - ref[n]) / max(np.linalg.norm(ref[n]), floor))
        worst = max(worst, rel)
    print(what, "bf16 worst rel L2", worst)
    assert worst <= band, (what, worst)
    return worst


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("entry", ["gru", "gru_head", "motion"])
def test_spatial_entry_matches_jax_unsharded(run, entry, kind):
    _, refs, ns2, _ = run
    ref = refs["entries"]
    outs = ([f"{entry}_{kind}"] if entry == "motion" else
            [f"{entry}_{kind}_h"] + ([f"{entry}_{kind}_dx"] if entry == "gru_head" else []))
    port, local = refs["port_entries"], ns2[0]["unsharded"]
    for key in outs:
        got = _gathered(ns2, key)
        assert got.shape == ref[key].shape
        # The sharding: against the same process's unsharded entry.
        assert (np.abs(got - local[key]) <= _bound(local[key], kind)).all(), \
            (key, float(np.abs(got - local[key]).max()))
        # The formulation: the port's unsharded entry against JAX's.
        assert (np.abs(port[key] - ref[key]) <= _bound(ref[key], kind)).all(), \
            (key, float(np.abs(port[key] - ref[key]).max()))
    pg = ns2[0][f"{entry}_{kind}_pgrads"]
    assert all(np.array_equal(pg[n], ns2[1][f"{entry}_{kind}_pgrads"][n]) for n in pg)
    ig = {n: np.concatenate([r[f"{entry}_{kind}_igrads"][n] for r in ns2], axis=1)
          for n in ns2[0][f"{entry}_{kind}_igrads"]}
    for got_grads, side in ((pg, "pgrads"), (ig, "igrads")):
        _check_grads(got_grads, {n: local[f"{entry}_{kind}_{side}"][n] for n in got_grads}, kind,
                     f"{entry} {kind} {side}, sharded against unsharded", BF16_GRAD_BAND["port"])
        _check_grads({n: port[f"{entry}_{kind}_{side}"][n] for n in got_grads},
                     ref[f"{entry}_{kind}_{side}"] if side == "pgrads" else
                     {n: ref[f"{entry}_{kind}_{side}"][n] for n in got_grads}, kind,
                     f"{entry} {kind} {side}, port against JAX", BF16_GRAD_BAND["jax"])


# -- the sharded forward ----------------------------------------------------------


def test_spatial_eval_fp32_matches_jax_unsharded(run):
    _, refs, ns2, _ = run
    got = ns2[0]["eval_fp32"]
    assert all(np.array_equal(r["eval_fp32"], got) for r in ns2)
    ref = refs["eval"]["eval_fp32"]
    assert got.shape == ref.shape == (1, 64, 64, 1)
    assert float(np.abs(got - ref).max()) <= 1e-4


def test_spatial_eval_bf16_engages_the_entries_in_the_canary_band(run):
    _, refs, ns2, _ = run
    got = ns2[0]["eval_bf16"]
    ref = refs["eval"]["eval_bf16"]
    assert got.shape == ref.shape == (1, 128, 64, 1)
    assert (np.abs(got - ref) <= CANARY_ATOL + CANARY_RTOL * np.abs(ref)).all(), \
        float(np.abs(got - ref).max())
    for r in ns2:
        calls = r["eval_bf16_calls"]
        # gru08 (+ head) and gru16 at 128 px: 2 spatial GRU calls and one
        # motion call an iteration; gru32's 4-row shard runs plain.
        assert calls == {"conv_gru_spatial": 2 * EVAL_ITERS, "motion_spatial": EVAL_ITERS}
        assert r["eval_fp32_calls"] == {"conv_gru_spatial": 0, "motion_spatial": 0}


# -- the (2, 2) grid's train step ------------------------------------------------

# The (2, 2) step's gradients against the one-process step's: per-leaf
# relative L2 within GRID_GRAD_BAND (tests/torch_ranks.py; the reading here
# 5.1e-6).


def test_data_and_space_grid_step_matches_the_one_process_step(run):
    _, refs, _, halo = run
    ref = refs["train"]
    for r in halo:
        host = r["train_22"]["host"]
        assert host["applied"] == 1.0 and host["finite"] == 1.0
        np.testing.assert_allclose(host["loss"], ref["host"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(host["grad_norm"], ref["host"]["grad_norm"], rtol=1e-5)
        for n, q in r["train_22"]["params"].items():
            np.testing.assert_allclose(q, ref["params"][n], atol=1e-5, err_msg=n)
    grads = halo[0]["train_22"]["grads"]
    assert set(grads) == set(ref["grads"])
    floor = 1e-2 * max(float(np.linalg.norm(g)) for g in ref["grads"].values())
    worst = max((float(np.linalg.norm(grads[n] - g) / max(np.linalg.norm(g), floor)), n)
                for n, g in ref["grads"].items())
    print("(2, 2) step gradients, worst relative L2", worst)
    assert worst[0] <= GRID_GRAD_BAND, worst
