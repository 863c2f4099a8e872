"""Training in the port (raft_stereo_tpu_torch) against the JAX package, on
the CPU: gradients, one optimizer step, the schedule, and the kernels'
backward.

- Gradients: ``jax.value_and_grad`` of the JAX package's ``sequence_loss``
  over ``raft_stereo_forward(test_mode=False)`` (eager: the jitted XLA CPU
  program's fp32 gradients of the feature net's stride-1 layers are 3% from
  fp64, the eager ones as close as the port's) and the port's
  ``loss.backward()`` on the same weights (the port's seeded weights, the
  flow head tempered as in test_torch_model.py, carried into JAX with
  ``transplant_state_dict``) and the same seeded inputs, 3 iterations, fp32,
  ``reg`` (``alt`` in test_torch_train_alt.py). Per leaf
  ``max|d| <= 1e-4 * max|g_jax| + 1e-6 + 3 * max|g_port32 - g_port64|``:
  the last term is the fp32 rounding of the leaf's gradient measured on the
  port's own fp64 copy (``port_grads64``). Leaves that sum a full-resolution
  map with heavy cancellation (the feature net's stem and layer1, before
  instance norm; the context net's heads at ReLU boundaries) carry up to
  1-2% of fp32 rounding in both packages alike; elsewhere the term is below
  the 1e-4. JAX's gradient is held to the port's fp64 one by the same
  bound. Every trainable leaf has a nonzero gradient on both sides.
- BatchNorm statistics (a route difference, ROADMAP Queue C): the JAX
  package keeps them as parameters, so its raw gradients give them nonzero
  leaves (pinned); the port keeps them as buffers. The comparison passes
  them through ``lax.stop_gradient`` in this file's own loss wrapper.
- One step: the port's ``make_train_step`` against the JAX package's step
  composition (``value_and_grad`` of the same wrapper, its ``make_optimizer``
  transform, ``optax.apply_updates``) from the same weights: the first Adam
  step moves each parameter by about ``lr * sign(g)``, so the updates agree
  to 1e-3 of that (beyond 4 ulps of the parameter) wherever ``|g_jax|``
  exceeds 1e-2 of its leaf's largest (above the fp32 rounding of the
  feature net's stem, 2e-3 of its largest) and its clipped value 100 times
  Adam's eps, and nowhere by more than twice it; the gradient norms to
  1e-4.
- The OneCycle learning rate equals the JAX package's
  ``onecycle_linear_schedule`` at every step of a 300-step horizon.
- Each kernel entry's backward (``ops/grad.py``; the lookup's written-out
  transpose) against autograd through its plain version, fp32; entries
  without a backward raise under grad; the differentiable entries never
  return a detached result.

The bf16 kernel routes are in test_torch_train_kernels.py and
test_torch_train_alt.py (:func:`check_bf16_case`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax import lax

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.engine.loss import sequence_loss as jx_sequence_loss
from raft_stereo_tpu.engine.optimizer import make_optimizer as jx_make_optimizer
from raft_stereo_tpu.engine.optimizer import onecycle_linear_schedule as jx_schedule
from raft_stereo_tpu.models import raft_stereo_forward as jx_forward
from raft_stereo_tpu.transplant.torch_loader import transplant_state_dict

from raft_stereo_tpu_torch import RAFTStereoConfig, init_raft_stereo
from raft_stereo_tpu_torch.corr import alt_cuda, reg_cuda
from raft_stereo_tpu_torch.corr.reg_cuda import Lane8, quantize_feature8
from raft_stereo_tpu_torch.engine.loss import sequence_loss
from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
from raft_stereo_tpu_torch.engine.steps import make_train_step
from raft_stereo_tpu_torch.models.extractor import MultiBasicEncoder
from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
from raft_stereo_tpu_torch.ops import encoder as enc
from raft_stereo_tpu_torch.ops import resident, stream
from raft_stereo_tpu_torch.transplant import params_from_jax

SMALL = dict(hidden_dims=(32, 32, 32))
ITERS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- shared helpers (test_torch_train_kernels.py imports them) ----------------


def port_model(cfg_kw: dict, seed: int = 0):
    """The port's seeded model with the flow head's last conv scaled by
    1/50 (test_torch_model.py's ``_temper``), in train mode."""
    model = init_raft_stereo(RAFTStereoConfig(**cfg_kw), seed=seed, device="cpu")
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.02)
        model.update_block.flow_head.conv2.bias.mul_(0.02)
    return model.train()


def jax_params(model, cfg_kw: dict):
    # Copies: on the CPU jnp.asarray may alias the numpy view of a torch
    # parameter, which an optimizer step then changes under JAX.
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return jax.tree_util.tree_map(jnp.asarray, transplant_state_dict(sd, JaxConfig(**cfg_kw)))


def batch(seed: int, b: int, h: int, w: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "flow": -rng.uniform(0, 8, (b, h, w, 1)).astype(np.float32),
            "valid": (rng.uniform(size=(b, h, w)) > 0.1).astype(np.float32)}


def stop_bn_stats(params):
    """The BatchNorm ``mean``/``var`` leaves through ``lax.stop_gradient``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: lax.stop_gradient(x)
        if getattr(path[-1], "key", None) in ("mean", "var") else x, params)


def jax_loss_fn(cfg_kw: dict, data: dict, stop_bn: bool = True):
    jcfg = JaxConfig(**cfg_kw)
    args = [jnp.asarray(data[k]) for k in ("image1", "image2", "flow", "valid")]

    def loss_fn(params):
        if stop_bn:
            params = stop_bn_stats(params)
        preds = jx_forward(params, jcfg, args[0], args[1], iters=ITERS)
        return jx_sequence_loss(preds, args[2], args[3])[0]

    return loss_fn


def jax_grads(params, cfg_kw: dict, data: dict, stop_bn: bool = True, jit: bool = True):
    """``(loss, grads, raw)``: JAX's value_and_grad, the grads in the port's
    state-dict layout (numpy), and the raw pytree."""
    fn = jax.value_and_grad(jax_loss_fn(cfg_kw, data, stop_bn))
    loss, grads = (jax.jit(fn) if jit else fn)(params)
    np_grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads)
    return float(loss), {k: v.numpy() for k, v in
                         params_from_jax(np_grads, RAFTStereoConfig(**cfg_kw)).items()}, grads


def port_grads(model, data: dict):
    """``(loss, {name: grad})`` of the port's train forward."""
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    model.zero_grad(set_to_none=True)
    preds = model(t["image1"], t["image2"], iters=ITERS, test_mode=False)
    loss, _ = sequence_loss(preds, t["flow"], t["valid"])
    loss.backward()
    return float(loss), {n: (p.grad.float().numpy() if p.grad is not None
                             else np.zeros(tuple(p.shape), np.float32))
                         for n, p in model.named_parameters()}


def port_grads64(model, data: dict):
    """:func:`port_grads` on an fp64 copy of the model (the compute dtype
    fp64; the correlation and the loss keep their fp32 casts): the measure
    of each leaf's fp32 rounding."""
    import copy
    m64 = copy.deepcopy(model).double()
    cls = RAFTStereoConfig
    saved = cls.compute_dtype
    cls.compute_dtype = property(lambda self: torch.float64)
    try:
        return port_grads(m64, data)
    finally:
        cls.compute_dtype = saved


def assert_fp32_grads_match(pgrads: dict, jgrads: dict, g64: dict) -> None:
    for name, g in pgrads.items():
        ref = jgrads[name]
        tol = (1e-4 * float(np.abs(ref).max()) + 1e-6
               + 3 * float(np.abs(g - g64[name]).max()))
        assert float(np.abs(g - ref).max()) <= tol, (name, float(np.abs(g - ref).max()), tol)
        assert float(np.abs(ref - g64[name]).max()) <= tol, name


def rel_l2(got: np.ndarray, ref: np.ndarray, floor: float) -> float:
    """Relative L2 distance, the denominator floored at ``floor``."""
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), floor))


def leaf_floor(grads: dict) -> float:
    """1e-2 of the largest leaf's gradient norm (test_torch_gpu.py's floor):
    a leaf whose true gradient is zero (a conv bias before instance norm)
    holds rounding noise on both sides, which no relative measure bounds."""
    return 1e-2 * max(float(np.linalg.norm(g)) for g in grads.values())


# bf16 bands (per-leaf relative L2, the denominator floored by
# :func:`leaf_floor` of the reference), each twice the largest reading of
# the two bf16 cases (reg_cuda at B=1 under fused_train: the lookup, the
# encoder chains and the loop kernels; alt_cuda at B=2; 128x256, 3
# iterations) on the CPU:
# - conv weights, port against JAX: largest 0.294 (fnet.conv1.weight, the
#   stem before instance norm, whose gradient sums a full-resolution map
#   with heavy cancellation: JAX's bf16 gradient reads 0.314 against the
#   port's fp32 one, the port's 0.314);
# - conv weights, the port's bf16 route against its fp32 gradient of the
#   same weights: largest 0.314 (fnet.conv1.weight);
# - 1-D leaves (biases, norm scales), the port's bf16 route against its
#   fp32 gradient: largest 0.0105 (cnet.conv1.bias). They are not held to
#   JAX's bf16 gradient, which sums them over the map in bf16 (its
#   flow_head.conv2.bias reads 0.79 against the port's fp32 one).
BF16_BAND_MAT = 0.59
BF16_BAND_PORT = 0.63
BF16_BAND_VEC = 0.021


def check_bf16_case(port_kw: dict, jax_kw: dict, b: int):
    """The port's bf16 kernel route against the JAX package's on the same
    weights and batch (128x256, B=b), and against the port's own fp32
    gradient, in the bands above. Returns the readings."""
    model = port_model(port_kw)
    data = batch(2, b, 128, 256)
    _, jgrads, _ = jax_grads(jax_params(model, jax_kw), jax_kw, data)
    _, pgrads = port_grads(model, data)
    fp32_kw = dict(port_kw, mixed_precision=False, fused_train=False,
                   corr_implementation=port_kw["corr_implementation"].replace("_cuda", ""))
    ref = port_model(fp32_kw)
    ref.load_state_dict(model.state_dict())
    _, g32 = port_grads(ref, data)
    assert_nonzero_leaves(pgrads, "port")
    assert_nonzero_leaves({n: jgrads[n] for n in pgrads}, "jax")
    jfloor = leaf_floor({n: jgrads[n] for n in pgrads})
    floor32 = leaf_floor(g32)
    mats = [n for n, p in model.named_parameters() if p.dim() > 1]
    vecs = [n for n, p in model.named_parameters() if p.dim() == 1]
    readings = {"mat": max((rel_l2(pgrads[n], jgrads[n], jfloor), n) for n in mats),
                "port_fp32": max((rel_l2(pgrads[n], g32[n], floor32), n) for n in mats),
                "vec_fp32": max((rel_l2(pgrads[n], g32[n], floor32), n) for n in vecs)}
    print(port_kw, "B", b, readings)
    assert readings["mat"][0] <= BF16_BAND_MAT, readings
    assert readings["port_fp32"][0] <= BF16_BAND_PORT, readings
    assert readings["vec_fp32"][0] <= BF16_BAND_VEC, readings
    return readings


def assert_nonzero_leaves(grads: dict, side: str) -> None:
    zero = [n for n, g in grads.items() if not np.abs(g).max() > 0]
    assert not zero, f"{side}: leaves without gradient: {zero}"


# -- fp32 gradients against JAX ------------------------------------------------


@pytest.fixture(scope="module")
def reg_fp32():
    """The fp32 ``reg`` case, shared by the gradient and the step tests."""
    model = port_model(SMALL)
    params = jax_params(model, SMALL)
    data = batch(0, 1, 64, 128)
    return model, params, data, jax_grads(params, SMALL, data, jit=False)


def test_fp32_gradients_match_jax(reg_fp32):
    model, _, data, (jloss, jgrads, _) = reg_fp32
    ploss, pgrads = port_grads(model, data)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    assert_nonzero_leaves(pgrads, "port")
    assert_nonzero_leaves({n: jgrads[n] for n in pgrads}, "jax")
    assert_fp32_grads_match(pgrads, jgrads, port_grads64(model, data)[1])


def test_bn_statistics_get_no_gradient_in_the_port(reg_fp32):
    """The route difference's JAX half on the ``reg`` case: JAX's raw
    gradients (no stop-gradient) give the BatchNorm statistics nonzero
    leaves, while the port's statistics are buffers (its other half is
    pinned in test_torch_train_alt.py)."""
    model, params, data, _ = reg_fp32
    _, raw, _ = jax_grads(params, SMALL, data, stop_bn=False)
    stats = [k for k in raw if k.endswith(("running_mean", "running_var"))]
    assert stats and max(float(np.abs(raw[k]).max()) for k in stats) > 0
    state = model.state_dict(keep_vars=True)
    assert all(not state[k].requires_grad for k in stats)


def test_one_train_step_matches_jax(reg_fp32):
    """The port's make_train_step after one step against the JAX package's
    optimizer (``make_optimizer``'s transform, ``optax.apply_updates``)
    applied to the same gradients from the same weights: the step's clip,
    AdamW, weight decay and OneCycle position. The gradients themselves
    are held to JAX's in test_fp32_gradients_match_jax; the step's loss and
    gradient norm are held to JAX's here."""
    base, params, data, (jloss, _, jgrads) = reg_fp32
    model = port_model(SMALL)
    model.load_state_dict(base.state_dict())
    _, pgrads = port_grads(model, data)  # the gradients the step will take
    lr, num_steps, wdecay = 2e-4, 100, 1e-5
    before = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    opt = make_optimizer(model, lr, num_steps, wdecay, skip_nonfinite=3)
    step = make_train_step(model, opt, ITERS)
    host = step({k: torch.from_numpy(v) for k, v in data.items()})
    assert host["applied"] == 1.0 and host["skipped"] == 0.0
    np.testing.assert_allclose(host["loss"], jloss, rtol=1e-5)
    np.testing.assert_allclose(host["grad_norm"], float(optax.global_norm(jgrads)), rtol=1e-4)

    # The port's gradients in JAX's layout; the BatchNorm statistics' (the
    # port's buffers) zero, as lax.stop_gradient leaves them.
    by_id = {id(p): pgrads[n] for n, p in model.named_parameters()}
    grad_sd = {k: by_id.get(id(v), np.zeros(v.shape, np.float32))
               for k, v in model.state_dict(keep_vars=True).items()}
    grads = jax.tree_util.tree_map(jnp.asarray, transplant_state_dict(grad_sd, JaxConfig(**SMALL)))
    tx, _ = jx_make_optimizer(lr, num_steps, wdecay, skip_nonfinite=3)
    new = jax.jit(lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        params, grads)
    after_j = params_from_jax(jax.tree_util.tree_map(np.asarray, new), RAFTStereoConfig(**SMALL))
    eps = float(np.finfo(np.float32).eps)
    lr0 = lr / 25.0
    moved = 0
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        ref = after_j[name].numpy()
        # torch's AdamW decays, then steps (two roundings); optax adds one
        # update: a few ulps of the parameter, and Adam's quotient's own.
        tol = 4 * eps * np.maximum(np.abs(ref), np.abs(before[name])) + 1e-3 * lr0
        assert (np.abs(got - ref) <= tol).all(), (name, float(np.abs(got - ref).max()))
        moved += int((got != before[name]).sum())
    assert moved > 0.5 * sum(p.numel() for p in model.parameters())


def test_onecycle_lr_matches_jax_schedule():
    """The torch OneCycleLR the optimizer steps equals the JAX package's
    schedule at every step of a 300-step horizon (num_steps + 100)."""
    p = torch.nn.Parameter(torch.zeros(3))
    from raft_stereo_tpu_torch.engine.optimizer import TrainOptimizer, onecycle_linear_schedule
    opt = TrainOptimizer([p], 2e-4, 200)
    ref = jx_schedule(2e-4, 300)
    mine = onecycle_linear_schedule(2e-4, 300)
    for s in range(300):
        np.testing.assert_allclose(opt.lr, float(ref(s)), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(mine(s), float(ref(s)), rtol=1e-5, atol=1e-12)
        opt.step(True)


# -- the kernels' backward --------------------------------------------------------


def _grads(out, leaves, seed=0):
    """Gradients of a fixed random projection of ``out`` in ``leaves``."""
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,)) if o is not None]
    g = torch.Generator().manual_seed(seed)
    total = sum((o.float() * torch.randn(o.shape, generator=g)).sum() for o in outs)
    return torch.autograd.grad(total, leaves, allow_unused=True, retain_graph=True)


def _assert_same(got, ref, what):
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None or not a.abs().max() > 0, (what, i)
            continue
        assert a is not None, (what, i)
        tol = 1e-5 * float(b.abs().max()) + 1e-7
        assert float((a - b).abs().max()) <= tol, (what, i, float((a - b).abs().max()), tol)


def _rand(g, *shape, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).requires_grad_()


@pytest.mark.parametrize("pack8", [False, True])
def test_lookup_backward_is_the_transpose(pack8, monkeypatch):
    """The lookup's written-out backward equals autograd through the plain
    lookup (gather + lerp) on the levels, with the true-width mask; under
    pack8 the gradient goes to the bf16 levels."""
    if pack8:
        monkeypatch.setenv("RAFT_CORR_PACK8", "1")
    g = torch.Generator().manual_seed(0)
    dt = torch.bfloat16 if pack8 else torch.float32
    f1 = torch.randn(2, 4, 23, 16, generator=g).to(dt).requires_grad_()
    f2 = torch.randn(2, 4, 23, 16, generator=g).to(dt).requires_grad_()
    coords = torch.rand(2, 4, 23, generator=g) * 34 - 6  # off both ends too
    ops = reg_cuda.build_corr_operands(f1, f2, num_levels=3, radius=2)
    assert ops.pack8 == pack8
    out = reg_cuda.lookup(ops, coords)
    assert out.grad_fn is not None
    got = _grads(out, ops.levels)
    ref = _grads(reg_cuda.lookup_pyramid([lvl.float() for lvl in ops.levels],
                                         coords.reshape(-1), 2).to(dt).reshape(out.shape),
                 ops.levels)
    for a, b in zip(got, ref):
        assert a.dtype == dt
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=0, atol=1e-2 if pack8 else 1e-6)
    # through the pyramid to both feature maps
    assert all(t.abs().max() > 0 for t in torch.autograd.grad(out.float().sum(), [f1, f2]))


def test_lookup_backward_has_no_atomics_bits():
    """Two backward passes of one lookup give the same bits (a scatter into
    each pixel's own row, no accumulation order)."""
    g = torch.Generator().manual_seed(1)
    f1 = torch.randn(1, 3, 40, 8, generator=g, requires_grad=True)
    f2 = torch.randn(1, 3, 40, 8, generator=g, requires_grad=True)
    coords = torch.rand(1, 3, 40, generator=g) * 40
    grads = []
    for _ in range(2):
        ops = reg_cuda.build_corr_operands(f1, f2, num_levels=4, radius=4)
        grads.append(torch.autograd.grad(reg_cuda.lookup(ops, coords).sum(), [f1, f2]))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_alt_lookup_backward_matches_plain_alt():
    g = torch.Generator().manual_seed(2)
    f1 = torch.randn(2, 3, 20, 16, generator=g, requires_grad=True)
    f2 = torch.randn(2, 3, 20, 16, generator=g, requires_grad=True)
    coords = torch.rand(2, 3, 20, generator=g) * 26 - 3
    out = alt_cuda.make_alt_cuda_corr_fn(f1, f2, num_levels=3, radius=2)(coords)
    assert out.grad_fn is not None
    from raft_stereo_tpu_torch.corr.alt import make_alt_corr_fn
    ref = make_alt_corr_fn(f1, f2, num_levels=3, radius=2)(coords)
    _assert_same(_grads(out, [f1, f2]), _grads(ref, [f1, f2]), "alt")


def _gru_module(g, ch, cin):
    m = ConvGRU(ch, cin)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return m


@pytest.mark.parametrize("head", [False, True])
def test_conv_gru_backward(head):
    """fused_conv_gru's backward reaches h, the context, the x parts and the
    module parameters through gru_weights / head_weights /
    prepare_gru_context, as autograd through conv_gru_plain does."""
    g = torch.Generator().manual_seed(3)
    gru = _gru_module(g, 32, 64)
    fh = FlowHead(32, 64, 2)
    h = _rand(g, 1, 6, 10, 32)
    ctx = [_rand(g, 1, 6, 10, 32) for _ in range(3)]
    xs = [_rand(g, 1, 6, 10, 32), _rand(g, 1, 6, 10, 32)]
    leaves = [h, *ctx, *xs, *gru.parameters(), *(fh.parameters() if head else [])]

    def run(fn):
        czrq = stream.prepare_gru_context(gru, ctx, torch.float32)
        w = stream.gru_weights(gru, torch.float32, "gru08")
        hd = stream.head_weights(fh, torch.float32) if head else None
        return fn(w, h, czrq, *xs, head=hd)

    out = run(stream.fused_conv_gru)
    assert out[0].grad_fn is not None
    _assert_same(_grads(out, leaves), _grads(run(stream.conv_gru_plain), leaves), "gru")


def test_motion_and_gru1632_backward():
    g = torch.Generator().manual_seed(4)
    enc_m = BasicMotionEncoder(2 * 5)
    with torch.no_grad():
        for p in enc_m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    flow = torch.cat([_rand(g, 1, 6, 10, 1), torch.zeros(1, 6, 10, 1)], -1)
    corr = _rand(g, 1, 6, 10, 10)
    leaves = [flow, corr, *enc_m.parameters()]

    def motion(fn):
        return fn(stream.motion_weights(enc_m, torch.float32), flow, corr)

    out = motion(stream.fused_motion)
    assert out.grad_fn is not None
    _assert_same(_grads(out, leaves), _grads(motion(stream.motion_plain), leaves), "motion")

    g16, g32 = _gru_module(g, 32, 64), _gru_module(g, 32, 32)
    h16, h32 = _rand(g, 1, 8, 12, 32), _rand(g, 1, 4, 6, 32)
    c16 = [_rand(g, 1, 8, 12, 32) for _ in range(3)]
    c32 = [_rand(g, 1, 4, 6, 32) for _ in range(3)]
    x0p, x1p = _rand(g, 1, 8, 12, 32), _rand(g, 1, 4, 6, 32)
    leaves = [h16, h32, x0p, x1p, *c16, *c32, *g16.parameters(), *g32.parameters()]

    def both(fn):
        return fn(stream.gru_weights(g16, torch.float32, "gru16"),
                  stream.gru_weights(g32, torch.float32, "gru32"), h16, h32,
                  stream.prepare_gru_context(g16, c16, torch.float32),
                  stream.prepare_gru_context(g32, c32, torch.float32), x0p, x1p)

    out = both(stream.fused_gru1632)
    assert all(o.grad_fn is not None for o in out)
    _assert_same(_grads(out, leaves), _grads(both(stream.gru1632_plain), leaves), "gru1632")


def _cnet(seed):
    model = MultiBasicEncoder(output_dim=[(32, 32, 32), (32, 32, 32)], norm_fn="batch",
                              downsample=2)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.named_parameters():
            t.copy_(torch.randn(t.shape, generator=g) * (0.1 if t.ndim > 1 else 0.05)
                    + (1.0 if "norm" in name and name.endswith("weight") else 0.0))
        for name, t in model.named_buffers():
            if name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    return model


@pytest.mark.parametrize("chain", ["stem_layer1", "in_stem_layer1", "resblock_bn",
                                   "resblock_in", "head_conv"])
def test_encoder_chain_backward(chain):
    """Each encoder chain's backward (BatchNorm folded differentiably, the
    instance-norm statistics differentiated) against autograd through the
    same chain of plain versions; module_weights in grad mode gives the
    convs gradients."""
    model = _cnet(5)
    g = torch.Generator().manual_seed(6)
    if chain in ("stem_layer1", "in_stem_layer1"):
        x = _rand(g, 1, 12, 20, 3)
        params = [p for c, n in enc._layer1_convs(model) for p in
                  (c.weight, c.bias, *((n.weight, n.bias) if chain == "stem_layer1" else ()))]
        fn = enc.fused_stem_layer1 if chain == "stem_layer1" else enc.fused_in_stem_layer1

        def plain():
            pairs = enc._layer1_convs(model)
            if chain == "in_stem_layer1":
                pairs = [(c, None) for c, _ in pairs]
            convs = [enc.ConvWeights(*(enc.fold_bn(c, n) if n is not None else enc._conv_wb(c)))
                     for c, n in pairs]
            return enc._trunk_passes(x, convs, chain == "in_stem_layer1", plain=True)
        out = fn(model, x)
    elif chain.startswith("resblock"):
        block = model.layer2[1]
        norm_fn = "batch" if chain == "resblock_bn" else "instance"
        x = _rand(g, 1, 6, 10, 96)
        params = [p for c, n in enc._block_pairs(block, norm_fn)
                  for p in (c.weight, c.bias, *((n.weight, n.bias) if n is not None else ()))]

        def plain():
            convs = [enc.module_weights(c, n) for c, n in enc._block_pairs(block, norm_fn)]
            return enc._resblock(x, convs, norm_fn == "instance", False, plain=True)
        out = enc.stream_resblock(block, x, norm_fn)
    else:
        conv = model.outputs08[0][1]
        x = _rand(g, 1, 6, 10, 128)
        params = [conv.weight, conv.bias]

        def plain():
            return enc.conv_pass_plain("raw1", [(x, None, None)], enc.module_weights(conv),
                                       None, stats=False)[0]
        out = enc.stream_head_conv(conv, x)
    assert out.grad_fn is not None
    leaves = [x, *params]
    got = _grads(out, leaves)
    assert all(t is not None and t.abs().max() > 0 for t in got)
    _assert_same(got, _grads(plain(), leaves), chain)


def test_entries_without_backward_raise_under_grad(monkeypatch):
    """The resident iteration, the int8 lane and q8 entries and the single
    encoder launches raise under grad with an input that requires grad; in
    no_grad they run."""
    g = torch.Generator().manual_seed(7)
    model = _cnet(8)
    conv = model.outputs08[0][1]
    x = _rand(g, 1, 6, 10, 128)
    monkeypatch.setenv("RAFT_LANE_PACK8", "1")
    with pytest.raises(RuntimeError, match="enc_pass/q8"):
        enc.stream_head_conv_q8(conv, x)
    with pytest.raises(RuntimeError, match="enc_p"):
        enc.stream_resblock_q8(model.layer3[1], _rand(g, 1, 6, 10, 128), "batch")
    with pytest.raises(RuntimeError, match="enc_stem"):
        enc.stem(_rand(g, 1, 8, 8, 3), enc.module_weights(model.conv1), None, stats=False)
    with pytest.raises(RuntimeError, match="enc_point2"):
        enc.point2(x, (x, None, None), norm=False)
    with torch.no_grad():
        assert isinstance(enc.stream_head_conv_q8(conv, x), Lane8)
    gru = _gru_module(g, 32, 32)
    h = _rand(g, 1, 6, 10, 32)
    czrq8 = quantize_feature8(stream.prepare_gru_context(
        gru, [torch.randn(1, 6, 10, 32, generator=g) for _ in range(3)], torch.float32))
    w = stream.gru_weights(gru, torch.float32, "gru08")
    with pytest.raises(RuntimeError, match="conv_gru:gru08:lane8"):
        stream.fused_conv_gru(w, h, czrq8, _rand(g, 1, 6, 10, 32))
    # the resident iteration: test mode only
    ub_cfg = RAFTStereoConfig(hidden_dims=(32, 32, 32), corr_levels=2, corr_radius=2)
    m = init_raft_stereo(ub_cfg, device="cpu")
    ub = m.update_block
    f = torch.randn(1, 6, 10, 16, generator=g, requires_grad=True)
    ops = reg_cuda.build_corr_operands(f, f, num_levels=2, radius=2)
    inp = [[torch.randn(1, 6, 10, 32, generator=g) for _ in range(3)]]
    fused = ub.prepare_fused(inp * 3, torch.float32, train=True)
    coords = torch.rand(1, 6, 10, generator=g) * 10
    args = (fused.motion, fused.gru[0], fused.head, ops, h, fused.czrq[0], coords,
            torch.zeros(1, 6, 10, 2), _rand(g, 1, 6, 10, 32))
    with pytest.raises(RuntimeError, match="fused_iter"):
        resident.fused_iter(*args)
    with torch.no_grad():
        resident.fused_iter(*args)
