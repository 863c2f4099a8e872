"""RAFT-Stereo: encoders, correlation, and the refinement loop, test mode.

Counterpart of the JAX package's ``models/raft_stereo.py``. Inputs and
outputs are NHWC: images ``(B, H, W, 3)`` in [0, 255]; the low-resolution
flow ``(B, H/f, W/f, 2)`` and the upsampled field ``(B, H, W, 1)``, whose x
is negative disparity.

The refinement runs as a Python loop over a carried state ``{net, inp,
fmap1, fmap2, coords1}`` (:func:`raft_stereo_prepare`). A segment rebuilds
the correlation pyramid and the loop-invariant kernel inputs from the carry
and advances it (:func:`raft_stereo_segment_carry`); the mask head and the
convex upsample run once at the end (:func:`raft_stereo_epilogue`). The
test-mode forward is exactly prepare, one segment and the epilogue, so k
segments of m iterations and one segment of k*m give the same bits.

Per iteration, as in the JAX package: the flow is cast to the compute dtype,
the x position feeds the correlation lookup, the update block steps the GRUs
coarse to fine, and the y delta is zeroed in fp32 (the epipolar projection).
In bf16 with ``reg_cuda`` the JAX package's default loop runs: the gru16+32
kernel, then the resident iteration kernel in place of the lookup, motion
and gru08 kernels (``RAFT_FUSE_GRU1632``, ``RAFT_FUSE_ITER``; either off
gives the serial kernels, with the same bits). With ``alt_cuda`` there is
no pyramid for the resident kernel to gather from, so the loop runs the
gru16+32 kernel, the alt kernel, then the motion and gru08+head kernels.
With ``slow_fast_gru`` each iteration first steps the coarse GRUs more, as
in the JAX package: gru32 alone (3 levels), then gru32 with gru16 (one
gru16+32 launch where it engages; gru16 alone at 2 levels), on every loop.

Train mode (:func:`raft_stereo_train_forward`, ``forward(test_mode=False)``)
follows the JAX package's scan: each iteration detaches the coordinates
(truncated BPTT), steps the GRUs, computes the mask head and upsamples, and
runs under ``torch.utils.checkpoint`` (the JAX package remats each step), so
the backward recomputes one iteration at a time. Kernel engagement is the
JAX package's: the correlation kernels always (``reg_cuda``, ``alt_cuda``),
the loop kernels only under ``fused_train`` (bf16), the
resident iteration never, and the encoder kernels where their gates hold
(bf16, B=1). Each kernel's backward is plain torch (``ops/grad.py``).
BatchNorm's running statistics are buffers, as in the reference: they get
no gradient, no weight decay and no part in the clip norm (the JAX package
keeps them as parameters and trains them; a route difference).

Height sharding (``space``, a ``parallel.ProcessGrid`` with a space axis;
the JAX package's ``space_mesh``): every rank of a space row runs the
encoders whole, at full height, on the plain route (the JAX package gates
its encoder kernels off under a ``space`` mesh), then keeps its rows of the
feature maps and of each level's context and state. The correlation volume
and its lookup are built over those rows only (rows are independent). The
refinement loop runs on them (``models/update.py``: the kernels' spatial
entries, halo rows between neighbours), without the resident iteration,
gru16+32 or the int8 lanes; the mask head and the convex upsample take one
halo row. The outputs are the rank's rows; :meth:`ProcessGrid.gather_rows`
gives the whole map. Gradients of the replicated encoders are partial on
each rank and add up over the space row (``engine/steps.py``).

The serving scheduler composes carries into one batch and back
(:func:`stack_refinement_states`, :func:`take_refinement_rows`): every leaf
of a carry, a ``Lane8`` container's ``q`` and ``scale`` included, has the
batch as its leading axis. A data-mesh session's carries are
:class:`ShardedCarry` parts, each on its shard's device; the same two
helpers gather and join them part by part, and :func:`shard_rows` lays a
carry out as a mesh program's shards.

Under ``RAFT_LANE_PACK8`` (the JAX package's narrow lanes): the prepare step
quantizes each zqr level's output (the quantize-on-exit pass where its gate
holds, else the conv's output rounded to the compute dtype, on the host) and
both feature maps into int8 containers (``corr/reg_cuda.py:Lane8``), which
ride the carry; ``net`` stays in the compute dtype. A segment dequantizes
what the carry holds once, before its loop, whatever the switch says then,
and with the kernels in use folds the biases into czrq and quantizes that
again (``ops/stream.py:prepare_gru_context_any``). The forward is prepare,
segment and epilogue, so it goes through the same two quantizations.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from raft_stereo_tpu_torch.config import (
    RAFTStereoConfig, fuse_iter_on, lane_pack8_on, plain_encoders, resolve_device)
from raft_stereo_tpu_torch.corr import make_corr
from raft_stereo_tpu_torch.corr.reg_cuda import Lane8, dequantize_feature8, quantize_feature8
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.models.layers import Conv2d, ResidualBlock, init_weights
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock
from raft_stereo_tpu_torch.obs.tracing import stage
from raft_stereo_tpu_torch.ops.coords import coords_grid
from raft_stereo_tpu_torch.ops.encoder import head_conv_q8_streamable, stream_head_conv_q8
from raft_stereo_tpu_torch.ops.upsample import convex_upsample

# From this many pixels up, the two images go through the feature net one
# after the other instead of as one batch (instance norm is per sample, so
# the outputs are the same), halving the peak activation memory.
FNET_SEQUENTIAL_MIN_PIXELS = 1 << 21


class RAFTStereo(nn.Module):
    """Module tree and parameter names of the reference ``RAFTStereo``."""

    def __init__(self, cfg: RAFTStereoConfig):
        super().__init__()
        self.cfg = cfg
        self.cnet = MultiBasicEncoder(
            output_dim=[cfg.hidden_dims, cfg.context_dims], norm_fn="batch",
            downsample=cfg.n_downsample)
        self.update_block = BasicMultiUpdateBlock(cfg)
        self.context_zqr_convs = nn.ModuleList(
            Conv2d(cfg.context_dims[i], cfg.hidden_dims[i] * 3, 3, padding=1)
            for i in range(cfg.n_gru_layers))
        if cfg.shared_backbone:
            self.conv2 = nn.Sequential(ResidualBlock(128, 128, "instance", stride=1),
                                       Conv2d(128, 256, 3, padding=1))
        else:
            self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                     downsample=cfg.n_downsample)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12,
                flow_init: Optional[torch.Tensor] = None, test_mode: bool = False,
                space=None):
        """Test mode: ``(flow_low, flow_up)``; train mode: the per-iteration
        upsampled predictions ``(iters, B, H, W, 1)``. With ``space`` the
        outputs are this rank's rows."""
        if not test_mode:
            return raft_stereo_train_forward(self, image1, image2, iters=iters,
                                             flow_init=flow_init, space=space)
        return raft_stereo_forward(self, image1, image2, iters=iters, flow_init=flow_init,
                                   space=space)


def init_raft_stereo(cfg: RAFTStereoConfig, *, seed: int = 0,
                     device=None) -> RAFTStereo:
    """A model with random weights from ``seed``, in eval mode on ``device``
    (CUDA unless the caller asks for another)."""
    dev = resolve_device(device)
    model = RAFTStereo(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def _packed_context_level(conv, x: torch.Tensor, dtype: torch.dtype) -> Lane8:
    """One zqr level as an int8 container: the quantize-on-exit pass where
    its gate holds, else the conv's output rounded to ``dtype`` and
    quantized on the host."""
    if head_conv_q8_streamable(conv, x):
        return stream_head_conv_q8(conv, x)
    return quantize_feature8(conv(x).to(dtype))


def _context_and_features(model: RAFTStereo, image1: torch.Tensor,
                          image2: torch.Tensor, pack: bool, space=None):
    if space is not None:
        # The encoders run whole on every rank of the space row, plain;
        # each rank keeps its rows of every map.
        with plain_encoders():
            net, inp, fmap1, fmap2 = _context_and_features(model, image1, image2, False)
        return (tuple(x[:, space.rows(x.shape[1])] for x in net),
                tuple(tuple(c[:, space.rows(c.shape[1])] for c in lvl) for lvl in inp),
                fmap1[:, space.rows(fmap1.shape[1])], fmap2[:, space.rows(fmap2.shape[1])])
    cfg = model.cfg
    dt = cfg.compute_dtype
    image1 = (2 * (image1.float() / 255.0) - 1.0).to(dt)
    image2 = (2 * (image2.float() / 255.0) - 1.0).to(dt)
    b = image1.shape[0]
    if cfg.shared_backbone:
        *cnet_list, x = model.cnet(torch.cat([image1, image2]), dual_inp=True,
                                   num_layers=cfg.n_gru_layers)
        x = model.conv2(x)
        fmap1, fmap2 = x[:b], x[b:]
    else:
        cnet_list = model.cnet(image1, num_layers=cfg.n_gru_layers)
        if image1.shape[1] * image1.shape[2] >= FNET_SEQUENTIAL_MIN_PIXELS:
            fmap1, fmap2 = model.fnet(image1), model.fnet(image2)
        else:
            fmaps = model.fnet(torch.cat([image1, image2]))
            fmap1, fmap2 = fmaps[:b], fmaps[b:]
    net = tuple(torch.tanh(x[0]) for x in cnet_list)
    if pack:
        inp = tuple(_packed_context_level(conv, torch.relu(x[1]), dt)
                    for x, conv in zip(cnet_list, model.context_zqr_convs))
    else:
        inp = tuple(tuple(conv(torch.relu(x[1])).chunk(3, dim=-1))
                    for x, conv in zip(cnet_list, model.context_zqr_convs))
    return net, inp, fmap1, fmap2


@torch.no_grad()
def raft_stereo_prepare(model: RAFTStereo, image1: torch.Tensor, image2: torch.Tensor,
                        *, flow_init: Optional[torch.Tensor] = None, space=None) -> dict:
    """Everything outside the refinement loop: the encoders and the zqr
    context convs. Returns the carry ``{net, inp, fmap1, fmap2, coords1}``;
    ``flow_init`` seeds ``coords1 = coords0 + flow_init``. Under
    ``RAFT_LANE_PACK8`` each ``inp`` level (all 3ch channels) and the two
    fmaps are int8 containers. With ``space`` the carry holds this rank's
    rows (``flow_init`` too), never packed. A ``raft.encode`` profiler
    range."""
    with stage("encode"):
        pack = lane_pack8_on() and space is None
        net, inp, fmap1, fmap2 = _context_and_features(model, image1, image2, pack, space)
        b, h, w, _ = fmap1.shape
        coords1 = coords_grid(b, h, w, device=fmap1.device).clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init
        if pack:
            fmap1, fmap2 = quantize_feature8(fmap1), quantize_feature8(fmap2)
    return {"net": net, "inp": inp, "fmap1": fmap1, "fmap2": fmap2,
            "coords1": coords1}


@torch.no_grad()
def raft_stereo_segment_carry(model: RAFTStereo, state: dict, *, iters: int,
                              warm_start: bool = False, space=None):
    """Advance the carry ``iters`` iterations. Returns ``(new_state,
    dnorm)``, where ``dnorm`` (B,) fp32 is the mean per-iteration |delta x|
    over the segment (over the whole height under ``space``). ``warm_start``
    keeps the motion encoder off the kernels (the motion kernel and the
    resident iteration), as a caller-supplied flow_init requires. The
    correlation volume and the iterations are a ``raft.loop`` profiler
    range."""
    with stage("loop"):
        return _segment_carry(model, state, iters=iters, warm_start=warm_start, space=space)


def _segment_carry(model: RAFTStereo, state: dict, *, iters: int, warm_start: bool,
                   space):
    cfg = model.cfg
    dt = cfg.compute_dtype
    ub = model.update_block
    # A packed carry (RAFT_LANE_PACK8) is dequantized here, once a segment,
    # keyed on what the carry holds rather than on the switch.
    inp = [tuple(dequantize_feature8(lvl, dt).chunk(3, dim=-1))
           if isinstance(lvl, Lane8) else lvl for lvl in state["inp"]]
    fmap1, fmap2 = (dequantize_feature8(f, dt) if isinstance(f, Lane8) else f
                    for f in (state["fmap1"], state["fmap2"]))
    # The plain correlations stay fp32 under bf16, as in the JAX package;
    # the kernel-backed ones take the feature maps in the compute dtype.
    corr_dtype = torch.float32 if cfg.corr_kind in ("reg", "alt") else dt
    corr_fn, corr_ops = make_corr(cfg.corr_kind, fmap1.to(corr_dtype), fmap2.to(corr_dtype),
                                  num_levels=cfg.corr_levels, radius=cfg.corr_radius,
                                  out_dtype=dt)
    del fmap1, fmap2  # the loop reads the operands: a packed carry's dequantized maps go
    coords_in = state["coords1"]
    b, h, w = coords_in.shape[:3]
    coords0 = coords_grid(b, h, w, device=coords_in.device)
    fused = (ub.prepare_fused(inp, dt, space=space, net=state["net"])
             if cfg.loop_kernels(test_mode=True) else None)
    # The resident iteration, as in the JAX package: with the kernels in
    # use, reg_cuda's operands, RAFT_FUSE_ITER on, no warm start (the
    # kernel's motion encoder drops the flow-y weights) and no height shard.
    resident = (fused is not None and corr_ops is not None and not warm_start
                and fuse_iter_on() and space is None)
    net, coords1 = state["net"], coords_in
    n = cfg.n_gru_layers
    for _ in range(iters):
        flow = (coords1 - coords0).to(dt)
        if cfg.slow_fast_gru:
            # The JAX package's pre-steps: the coarse GRUs step more often
            # than gru08, gru32 alone first (3 levels), then gru32 with gru16.
            if n == 3:
                net = ub.step_coarse(net, inp, fused, iter16=False, space=space)
            if n >= 2:
                net = ub.step_coarse(net, inp, fused, space=space)
        if resident:
            net, delta_flow = ub.step_resident(net, inp, corr_ops, coords1[..., 0], flow,
                                               fused=fused)
        else:
            corr = corr_fn(coords1[..., 0])
            net, delta_flow = ub(net, inp, corr, flow, fused=fused,
                                 fuse_motion=not warm_start, space=space)
        dx = delta_flow[..., :1].float()
        coords1 = coords1 + torch.cat([dx, torch.zeros_like(dx)], dim=-1)
    dnorm = (coords1 - coords_in)[..., 0].abs().mean(dim=(1, 2)) / float(iters)
    if space is not None:
        # Equal shards: the whole map's mean is the mean of the shards'.
        dnorm = space.gather_rows(dnorm[:, None]).mean(dim=1)
    return dict(state, net=net, coords1=coords1), dnorm


@torch.no_grad()
def raft_stereo_epilogue(model: RAFTStereo, state: dict, space=None):
    """Mask head and convex upsample of the x channel, in fp32, from a
    carry. Returns ``(flow_low, flow_up)``. A ``raft.epilogue`` profiler
    range."""
    with stage("epilogue"):
        coords1 = state["coords1"]
        b, h, w = coords1.shape[:3]
        flow_low = coords1 - coords_grid(b, h, w, device=coords1.device)
        up_mask = model.update_block.mask_head(state["net"][0], space)
        flow_up = convex_upsample(flow_low[..., :1].float(), up_mask.float(),
                                  model.cfg.downsample_factor, space)
    return flow_low, flow_up


@torch.no_grad()
def raft_stereo_segment(model: RAFTStereo, state: dict, *, iters: int,
                        warm_start: bool = False, space=None):
    """Advance ``iters`` iterations and upsample. Returns ``(new_state,
    flow_low, flow_up)``."""
    new_state, _ = raft_stereo_segment_carry(model, state, iters=iters,
                                             warm_start=warm_start, space=space)
    return (new_state, *raft_stereo_epilogue(model, new_state, space))


@torch.no_grad()
def raft_stereo_forward(model: RAFTStereo, image1: torch.Tensor, image2: torch.Tensor,
                        *, iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                        space=None):
    """Test-mode forward: ``(flow_low, flow_up)``, this rank's rows under
    ``space`` (whose ``flow_init`` is its rows too)."""
    state = raft_stereo_prepare(model, image1, image2, flow_init=flow_init, space=space)
    _, flow_low, flow_up = raft_stereo_segment(model, state, iters=iters,
                                               warm_start=flow_init is not None, space=space)
    return flow_low, flow_up


def raft_stereo_train_forward(model: RAFTStereo, image1: torch.Tensor, image2: torch.Tensor,
                              *, iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                              space=None) -> torch.Tensor:
    """Train-mode forward (the JAX package's ``raft_stereo_forward(...,
    test_mode=False)``): the per-iteration upsampled predictions ``(iters,
    B, H, W, 1)`` fp32, differentiable in the model's parameters; this
    rank's rows of them under ``space``."""
    cfg = model.cfg
    dt = cfg.compute_dtype
    ub = model.update_block
    net, inp, fmap1, fmap2 = _context_and_features(model, image1, image2, False, space)
    corr_dtype = torch.float32 if cfg.corr_kind in ("reg", "alt") else dt
    corr_fn, _ = make_corr(cfg.corr_kind, fmap1.to(corr_dtype), fmap2.to(corr_dtype),
                           num_levels=cfg.corr_levels, radius=cfg.corr_radius, out_dtype=dt)
    fused = (ub.prepare_fused(inp, dt, train=True, space=space, net=net)
             if cfg.loop_kernels(test_mode=False) else None)
    b, h, w = fmap1.shape[:3]
    coords0 = coords_grid(b, h, w, device=fmap1.device)
    coords1 = coords0 if flow_init is None else coords0 + flow_init
    n = cfg.n_gru_layers
    fuse_motion = flow_init is None

    def one_iteration(coords1, *net):
        flow = (coords1 - coords0).to(dt)
        if cfg.slow_fast_gru:
            if n == 3:
                net = ub.step_coarse(net, inp, fused, iter16=False, space=space)
            if n >= 2:
                net = ub.step_coarse(net, inp, fused, space=space)
        corr = corr_fn(coords1[..., 0])
        net, delta_flow = ub(net, inp, corr, flow, fused=fused, fuse_motion=fuse_motion,
                             space=space)
        dx = delta_flow[..., :1].float()
        coords1 = coords1 + torch.cat([dx, torch.zeros_like(dx)], dim=-1)
        up_mask = ub.mask_head(net[0], space)
        flow_up = convex_upsample((coords1 - coords0)[..., :1].float(), up_mask.float(),
                                  cfg.downsample_factor, space)
        return (flow_up, coords1, *net)

    preds = []
    for _ in range(iters):
        # Truncated BPTT: no gradient through the coordinates (the
        # reference's coords1.detach()); each iteration is recomputed in
        # the backward, as the JAX package remats each scan step.
        flow_up, coords1, *net = checkpoint(one_iteration, coords1.detach(), *net,
                                            use_reentrant=False)
        preds.append(flow_up)
    return torch.stack(preds)


def _map_carry(fn, *carries):
    """``fn`` over the tensor leaves of carries of one structure (dicts,
    tuples, lists, ``Lane8`` containers)."""
    first = carries[0]
    if isinstance(first, torch.Tensor):
        return fn(*carries)
    if isinstance(first, dict):
        if any(c.keys() != first.keys() for c in carries):
            raise ValueError("carries with different keys")
        return {k: _map_carry(fn, *(c[k] for c in carries)) for k in first}
    if isinstance(first, (tuple, list)):
        if any(type(c) is not type(first) or len(c) != len(first) for c in carries):
            raise ValueError("carries of different structure")
        leaves = [_map_carry(fn, *xs) for xs in zip(*carries)]
        return type(first)(*leaves) if hasattr(first, "_fields") else type(first)(leaves)
    raise TypeError(f"unexpected carry leaf {type(first).__name__}")


class ShardedCarry:
    """A batched carry held in parts, each a carry of consecutive rows on
    its own device: the rows of a data-mesh program's shards. Row ``r`` of
    the whole is row ``r - offset`` of the part it falls in. Gathers and
    joins (:func:`take_refinement_rows`, :func:`stack_refinement_states`)
    leave every row on the device it is on; a row moves to another device
    only when a mesh program places it on another shard."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[dict]):
        self.parts = tuple(parts)
        if not self.parts:
            raise ValueError("a sharded carry needs >= 1 part")

    @property
    def widths(self) -> Tuple[int, ...]:
        return tuple(int(p["coords1"].shape[0]) for p in self.parts)

    def locate(self, row: int) -> Tuple[int, int]:
        """(part, row within the part) of row ``row`` of the whole."""
        for j, w in enumerate(self.widths):
            if row < w:
                return j, row
            row -= w
        raise IndexError("row past the sharded carry's width")


def carry_rows(state) -> int:
    """Batch rows of a carry, plain or sharded."""
    if isinstance(state, ShardedCarry):
        return sum(state.widths)
    return int(state["coords1"].shape[0])


def stack_refinement_states(states: Sequence[dict]) -> dict:
    """Concatenate carries along the batch axis (rows keep order). With a
    sharded carry among them the result is sharded: the parts are joined,
    no row moves."""
    if not states:
        raise ValueError("stack_refinement_states needs >= 1 state")
    if len(states) == 1:
        return states[0]
    if any(isinstance(s, ShardedCarry) for s in states):
        return ShardedCarry([p for s in states
                             for p in (s.parts if isinstance(s, ShardedCarry) else (s,))])
    return _map_carry(lambda *xs: torch.cat(xs, dim=0), *states)


def _take_rows(state: dict, rows: Sequence[int]) -> dict:
    leaf = state["coords1"]
    idx = torch.tensor([int(r) for r in rows], dtype=torch.long, device=leaf.device)
    return _map_carry(lambda x: x.index_select(0, idx), state)


def take_refinement_rows(state: dict, rows: Sequence[int]) -> dict:
    """Gather batch rows of a carry, in the order given; repeats are allowed
    (padding a batch to its bucket replicates a live row). A sharded carry
    gathers on each part's device: each run of consecutive rows drawn from
    one part becomes a part of the result."""
    if not isinstance(state, ShardedCarry):
        return _take_rows(state, rows)
    runs: list = []  # [part index, rows within it]
    for r in rows:
        j, local = state.locate(int(r))
        if runs and runs[-1][0] == j:
            runs[-1][1].append(local)
        else:
            runs.append([j, [local]])
    return ShardedCarry([_take_rows(state.parts[j], local) for j, local in runs])


def shard_rows(state, devices: Sequence[torch.device], rows: int) -> list:
    """A carry laid out as ``len(devices)`` shards of ``rows`` rows, shard
    ``i`` on ``devices[i]``: a sharded carry already in that layout is its
    parts; otherwise each shard's rows are gathered on the device they are
    on and copied device to device (never through the host)."""
    if isinstance(state, ShardedCarry) and state.widths == (rows,) * len(devices) and all(
            p["coords1"].device == torch.device(d) for p, d in zip(state.parts, devices)):
        return list(state.parts)
    out = []
    for i, dev in enumerate(devices):
        piece = take_refinement_rows(state, range(i * rows, (i + 1) * rows))
        parts = piece.parts if isinstance(piece, ShardedCarry) else (piece,)
        moved = [_map_carry(lambda x: x.to(dev, non_blocking=True), p) for p in parts]
        out.append(stack_refinement_states(moved))
    return out


def gather_rows(state, device: torch.device) -> dict:
    """A carry, plain or sharded, as one plain carry on ``device``."""
    if not isinstance(state, ShardedCarry):
        return state
    return shard_rows(state, [device], carry_rows(state))[0]


@torch.no_grad()
def raft_stereo_inference(model: RAFTStereo, image1: torch.Tensor, image2: torch.Tensor,
                          *, iters: int = 32, segments: int = 1,
                          flow_init: Optional[torch.Tensor] = None, space=None):
    """The test-mode forward with the loop split into ``segments`` chunks of
    ``iters // segments``. Returns ``(flow_low, flow_up)``."""
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    if iters % segments:
        raise ValueError(f"iters ({iters}) must be divisible by segments ({segments})")
    state = raft_stereo_prepare(model, image1, image2, flow_init=flow_init, space=space)
    flow_low = flow_up = None
    for _ in range(segments):
        state, flow_low, flow_up = raft_stereo_segment(
            model, state, iters=iters // segments, warm_start=flow_init is not None,
            space=space)
    return flow_low, flow_up
