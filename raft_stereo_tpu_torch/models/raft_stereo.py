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
Train mode waits for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from raft_stereo_tpu_torch.config import RAFTStereoConfig, resolve_device
from raft_stereo_tpu_torch.corr import make_corr_fn
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.models.layers import Conv2d, ResidualBlock, init_weights
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock
from raft_stereo_tpu_torch.ops.coords import coords_grid
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
                flow_init: Optional[torch.Tensor] = None, test_mode: bool = False):
        if not test_mode:
            raise NotImplementedError("train mode is not ported yet (ROADMAP Queue A, "
                                      "slice 4: training)")
        return raft_stereo_forward(self, image1, image2, iters=iters, flow_init=flow_init)


def init_raft_stereo(cfg: RAFTStereoConfig, *, seed: int = 0,
                     device=None) -> RAFTStereo:
    """A model with random weights from ``seed``, in eval mode on ``device``
    (CUDA unless the caller asks for another)."""
    dev = resolve_device(device)
    model = RAFTStereo(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def _context_and_features(model: RAFTStereo, image1: torch.Tensor,
                          image2: torch.Tensor):
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
    inp = tuple(tuple(conv(torch.relu(x[1])).chunk(3, dim=-1))
                for x, conv in zip(cnet_list, model.context_zqr_convs))
    return net, inp, fmap1, fmap2


@torch.no_grad()
def raft_stereo_prepare(model: RAFTStereo, image1: torch.Tensor, image2: torch.Tensor,
                        *, flow_init: Optional[torch.Tensor] = None) -> dict:
    """Everything outside the refinement loop: the encoders and the zqr
    context convs. Returns the carry ``{net, inp, fmap1, fmap2, coords1}``;
    ``flow_init`` seeds ``coords1 = coords0 + flow_init``."""
    net, inp, fmap1, fmap2 = _context_and_features(model, image1, image2)
    b, h, w, _ = fmap1.shape
    coords1 = coords_grid(b, h, w, device=fmap1.device).clone()
    if flow_init is not None:
        coords1 = coords1 + flow_init
    return {"net": net, "inp": inp, "fmap1": fmap1, "fmap2": fmap2,
            "coords1": coords1}


@torch.no_grad()
def raft_stereo_segment_carry(model: RAFTStereo, state: dict, *, iters: int,
                              warm_start: bool = False):
    """Advance the carry ``iters`` iterations. Returns ``(new_state,
    dnorm)``, where ``dnorm`` (B,) fp32 is the mean per-iteration |delta x|
    over the segment. ``warm_start`` keeps the motion encoder off the
    kernel, as a caller-supplied flow_init requires."""
    cfg = model.cfg
    dt = cfg.compute_dtype
    ub = model.update_block
    corr_dtype = torch.float32 if cfg.corr_kind == "reg" else dt
    corr_fn = make_corr_fn(cfg.corr_kind, state["fmap1"].to(corr_dtype),
                           state["fmap2"].to(corr_dtype), num_levels=cfg.corr_levels,
                           radius=cfg.corr_radius, out_dtype=dt)
    coords_in = state["coords1"]
    b, h, w = coords_in.shape[:3]
    coords0 = coords_grid(b, h, w, device=coords_in.device)
    inp = state["inp"]
    fused = ub.prepare_fused(inp, dt) if dt == torch.bfloat16 else None
    net, coords1 = state["net"], coords_in
    for _ in range(iters):
        flow = (coords1 - coords0).to(dt)
        corr = corr_fn(coords1[..., 0])
        net, delta_flow = ub(net, inp, corr, flow, fused=fused,
                             fuse_motion=not warm_start)
        dx = delta_flow[..., :1].float()
        coords1 = coords1 + torch.cat([dx, torch.zeros_like(dx)], dim=-1)
    dnorm = (coords1 - coords_in)[..., 0].abs().mean(dim=(1, 2)) / float(iters)
    return dict(state, net=net, coords1=coords1), dnorm


@torch.no_grad()
def raft_stereo_epilogue(model: RAFTStereo, state: dict):
    """Mask head and convex upsample of the x channel, in fp32, from a
    carry. Returns ``(flow_low, flow_up)``."""
    coords1 = state["coords1"]
    b, h, w = coords1.shape[:3]
    flow_low = coords1 - coords_grid(b, h, w, device=coords1.device)
    up_mask = model.update_block.mask_head(state["net"][0])
    flow_up = convex_upsample(flow_low[..., :1].float(), up_mask.float(),
                              model.cfg.downsample_factor)
    return flow_low, flow_up


@torch.no_grad()
def raft_stereo_segment(model: RAFTStereo, state: dict, *, iters: int,
                        warm_start: bool = False):
    """Advance ``iters`` iterations and upsample. Returns ``(new_state,
    flow_low, flow_up)``."""
    new_state, _ = raft_stereo_segment_carry(model, state, iters=iters,
                                             warm_start=warm_start)
    return (new_state, *raft_stereo_epilogue(model, new_state))


@torch.no_grad()
def raft_stereo_forward(model: RAFTStereo, image1: torch.Tensor, image2: torch.Tensor,
                        *, iters: int = 12, flow_init: Optional[torch.Tensor] = None):
    """Test-mode forward: ``(flow_low, flow_up)``."""
    state = raft_stereo_prepare(model, image1, image2, flow_init=flow_init)
    _, flow_low, flow_up = raft_stereo_segment(model, state, iters=iters,
                                               warm_start=flow_init is not None)
    return flow_low, flow_up


@torch.no_grad()
def raft_stereo_inference(model: RAFTStereo, image1: torch.Tensor, image2: torch.Tensor,
                          *, iters: int = 32, segments: int = 1,
                          flow_init: Optional[torch.Tensor] = None):
    """The test-mode forward with the loop split into ``segments`` chunks of
    ``iters // segments``. Returns ``(flow_low, flow_up)``."""
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    if iters % segments:
        raise ValueError(f"iters ({iters}) must be divisible by segments ({segments})")
    state = raft_stereo_prepare(model, image1, image2, flow_init=flow_init)
    flow_low = flow_up = None
    for _ in range(segments):
        state, flow_low, flow_up = raft_stereo_segment(
            model, state, iters=iters // segments, warm_start=flow_init is not None)
    return flow_low, flow_up
