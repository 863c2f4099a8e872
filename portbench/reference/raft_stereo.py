"""RAFT-Stereo in plain PyTorch, NCHW, the yardstick the port is judged by.

Written from the published model (princeton-vl/RAFT-Stereo: ``core/
raft_stereo.py``, ``core/extractor.py``, ``core/update.py``, ``core/corr.py``
``CorrBlock1D``, ``core/utils/utils.py`` ``InputPadder``; arXiv 2109.07547),
test mode, with the reference's module tree and parameter names, so one state
dict loads into it and into the port alike. It imports nothing of the port.

Departures, none of which changes the function computed:
- the correlation lookup gathers the two neighbours of each tap and lerps
  them, with zeros outside the row, where the reference calls
  ``grid_sample`` on a one-row image with ``align_corners=True`` (the same
  values);
- the feature net runs the two images one after the other (instance norm is
  per sample, so the output is the batch's);
- the convex upsample of the last iteration only, since test mode returns
  only that one;
- everything runs in the dtype of the weights (float32 for the yardstick;
  the reference's ``mixed_precision`` autocast is the port's business).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _norm(norm_fn: str, planes: int) -> nn.Module:
    """The two norms the stereo model uses: frozen BatchNorm in the context
    net, InstanceNorm in the feature net and the shared backbone's block."""
    return nn.BatchNorm2d(planes) if norm_fn == "batch" else nn.InstanceNorm2d(planes)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        if stride == 1 and in_planes == planes:
            self.downsample = None
        else:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class _Trunk(nn.Module):
    def __init__(self, norm_fn: str, downsample: int):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(3, 64, 7, stride=1 + (downsample > 2), padding=3)
        self.norm1 = _norm(norm_fn, 64)
        self.in_planes = 64
        self.layer1 = self._make_layer(64, 1)
        self.layer2 = self._make_layer(96, 1 + (downsample > 1))
        self.layer3 = self._make_layer(128, 1 + (downsample > 0))

    def _make_layer(self, dim: int, stride: int) -> nn.Sequential:
        layers = (ResidualBlock(self.in_planes, dim, self.norm_fn, stride),
                  ResidualBlock(dim, dim, self.norm_fn, 1))
        self.in_planes = dim
        return nn.Sequential(*layers)

    def trunk(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(_Trunk):
    def __init__(self, output_dim: int, norm_fn: str, downsample: int):
        super().__init__(norm_fn, downsample)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        return self.conv2(self.trunk(x))


class MultiBasicEncoder(_Trunk):
    def __init__(self, output_dim: Sequence[Sequence[int]], norm_fn: str, downsample: int):
        super().__init__(norm_fn, downsample)
        self.layer4 = self._make_layer(128, 2)
        self.layer5 = self._make_layer(128, 2)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, 1), nn.Conv2d(128, d[2], 3, padding=1))
            for d in output_dim)
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, 1), nn.Conv2d(128, d[1], 3, padding=1))
            for d in output_dim)
        self.outputs32 = nn.ModuleList(nn.Conv2d(128, d[0], 3, padding=1) for d in output_dim)

    def forward(self, x, dual_inp: bool = False, num_layers: int = 3):
        x = self.trunk(x)
        if dual_inp:
            v = x
            x = x[: x.shape[0] // 2]
        outputs = [[f(x) for f in self.outputs08]]
        if num_layers >= 2:
            y = self.layer4(x)
            outputs.append([f(y) for f in self.outputs16])
        if num_layers == 3:
            z = self.layer5(y)
            outputs.append([f(z) for f in self.outputs32])
        return (*outputs, v) if dual_inp else tuple(outputs)


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256, output_dim: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, output_dim, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.convz = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 64, 1, padding=0)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x, dest):
    return F.interpolate(x, dest.shape[2:], mode="bilinear", align_corners=True)


class BasicMultiUpdateBlock(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        hd = cfg["hidden_dims"]
        n = cfg["n_gru_layers"]
        self.n = n
        self.encoder = BasicMotionEncoder(cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1))
        self.gru08 = ConvGRU(hd[2], 128 + hd[1] * (n > 1))
        self.gru16 = ConvGRU(hd[1], hd[0] * (n == 3) + hd[2])
        self.gru32 = ConvGRU(hd[0], hd[1])
        self.flow_head = FlowHead(hd[2], hidden_dim=256, output_dim=2)
        factor = 2 ** cfg["n_downsample"]
        self.mask = nn.Sequential(nn.Conv2d(hd[2], 256, 3, padding=1), nn.ReLU(inplace=True),
                                  nn.Conv2d(256, factor * factor * 9, 1, padding=0))

    def forward(self, net, inp, corr=None, flow=None, iter08=True, iter16=True,
                iter32=True, update=True):
        if iter32:
            net[2] = self.gru32(net[2], *inp[2], pool2x(net[1]))
        if iter16:
            if self.n > 2:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]), interp(net[2], net[1]))
            else:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]))
        if iter08:
            motion = self.encoder(flow, corr)
            if self.n > 1:
                net[0] = self.gru08(net[0], *inp[0], motion, interp(net[1], net[0]))
            else:
                net[0] = self.gru08(net[0], *inp[0], motion)
        if not update:
            return net
        return net, self.flow_head(net[0])


class CorrBlock1D:
    """The all-pairs row correlation and its pyramid; a lookup returns
    ``levels * (2r+1)`` channels, level-major."""

    def __init__(self, fmap1, fmap2, num_levels: int, radius: int):
        self.num_levels, self.radius = num_levels, radius
        b, d, h, w1 = fmap1.shape
        corr = torch.einsum("aijk,aijh->ajkh", fmap1, fmap2) / math.sqrt(d)
        corr = corr.reshape(b * h * w1, 1, 1, -1)
        self.pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, [1, 2], stride=[1, 2])
            self.pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        b, _, h, w = coords.shape
        x = coords[:, 0].reshape(b * h * w, 1)
        dx = torch.arange(-r, r + 1, device=coords.device, dtype=coords.dtype)
        out = []
        for i, corr in enumerate(self.pyramid):
            row = corr.reshape(b * h * w, -1)
            w2 = row.shape[1]
            pos = x / 2 ** i + dx
            x0 = torch.floor(pos)
            frac = pos - x0
            x0 = x0.long()
            taps = []
            for k in (x0, x0 + 1):
                inside = (k >= 0) & (k < w2)
                v = torch.gather(row, 1, k.clamp(0, w2 - 1))
                taps.append(torch.where(inside, v, torch.zeros_like(v)))
            out.append((taps[0] * (1 - frac) + taps[1] * frac).reshape(b, h, w, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()


class RAFTStereo(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        # What the correlation's operands go through first: nothing in the
        # yardstick; a lower precision in the control (``fp8.py``).
        self.corr_cast = None
        hd = cfg["hidden_dims"]
        n = cfg["n_gru_layers"]
        self.cnet = MultiBasicEncoder([hd, hd], "batch", cfg["n_downsample"])
        self.update_block = BasicMultiUpdateBlock(cfg)
        self.context_zqr_convs = nn.ModuleList(
            nn.Conv2d(hd[i], hd[i] * 3, 3, padding=1) for i in range(n))
        if cfg["shared_backbone"]:
            self.conv2 = nn.Sequential(ResidualBlock(128, 128, "instance", 1),
                                       nn.Conv2d(128, 256, 3, padding=1))
        else:
            self.fnet = BasicEncoder(256, "instance", cfg["n_downsample"])

    def upsample_flow(self, flow, mask):
        n, d, h, w = flow.shape
        f = 2 ** self.cfg["n_downsample"]
        mask = torch.softmax(mask.view(n, 1, 9, f, f, h, w), dim=2)
        up = F.unfold(f * flow, [3, 3], padding=1).view(n, d, 9, 1, 1, h, w)
        up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
        return up.reshape(n, d, f * h, f * w)

    def forward(self, image1, image2, iters: int):
        """Test mode on NCHW images in [0, 255]: ``(flow_low, flow_up)``,
        ``flow_up`` the x channel only (negative disparity)."""
        cfg = self.cfg
        n = cfg["n_gru_layers"]
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        if cfg["shared_backbone"]:
            *cnet_list, x = self.cnet(torch.cat([image1, image2]), dual_inp=True,
                                      num_layers=n)
            fmap1, fmap2 = self.conv2(x).split(x.shape[0] // 2)
        else:
            cnet_list = self.cnet(image1, num_layers=n)
            fmap1, fmap2 = self.fnet(image1), self.fnet(image2)
        net = [torch.tanh(x[0]) for x in cnet_list]
        inp = [list(conv(F.relu(x[1])).split(conv.out_channels // 3, dim=1))
               for x, conv in zip(cnet_list, self.context_zqr_convs)]
        if self.corr_cast is not None:
            fmap1, fmap2 = self.corr_cast(fmap1), self.corr_cast(fmap2)
        corr_fn = CorrBlock1D(fmap1, fmap2, cfg["corr_levels"], cfg["corr_radius"])
        del fmap1, fmap2
        b, _, h, w = net[0].shape
        ys, xs = torch.meshgrid(torch.arange(h, device=net[0].device),
                                torch.arange(w, device=net[0].device), indexing="ij")
        coords0 = torch.stack([xs, ys]).to(net[0].dtype)[None].repeat(b, 1, 1, 1)
        coords1 = coords0.clone()
        ub = self.update_block
        for _ in range(iters):
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            if n == 3 and cfg["slow_fast_gru"]:
                net = ub(net, inp, iter32=True, iter16=False, iter08=False, update=False)
            if n >= 2 and cfg["slow_fast_gru"]:
                net = ub(net, inp, iter32=n == 3, iter16=True, iter08=False, update=False)
            net, delta_flow = ub(net, inp, corr, flow, iter32=n == 3, iter16=n >= 2)
            delta_flow[:, 1] = 0.0
            coords1 = coords1 + delta_flow
        mask = 0.25 * ub.mask(net[0])
        flow_up = self.upsample_flow(coords1 - coords0, mask)
        return coords1 - coords0, flow_up[:, :1]


def pad_pair(image1, image2, divis_by: int = 32) -> tuple:
    """The reference's ``InputPadder`` ('sintel' mode): replicate padding,
    centred, to multiples of ``divis_by``. Returns the padded pair and the
    (left, right, top, bottom) pads."""
    ht, wd = image1.shape[-2:]
    pad_ht = (((ht // divis_by) + 1) * divis_by - ht) % divis_by
    pad_wd = (((wd // divis_by) + 1) * divis_by - wd) % divis_by
    pads = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
    return (F.pad(image1, pads, mode="replicate"), F.pad(image2, pads, mode="replicate"),
            pads)


@torch.no_grad()
def disparity(model: RAFTStereo, left, right, iters: int) -> torch.Tensor:
    """Positive disparity (H, W) of one pair of (H, W, 3) images in [0, 255]
    (any dtype), as the reference's demo computes it: pad, test-mode
    forward, unpad, negate the x flow."""
    dtype = next(model.parameters()).dtype
    dev = next(model.parameters()).device
    l, r = (torch.as_tensor(x, device=dev).to(dtype).permute(2, 0, 1)[None]
            for x in (left, right))
    l, r, (pl, pr, pt, pb) = pad_pair(l, r)
    _, flow_up = model(l, r, iters)
    h, w = flow_up.shape[-2:]
    return -flow_up[0, 0, pt:h - pb, pl:w - pr]


def parameter_layout(cfg: dict) -> List[tuple]:
    """``(name, shape, kind)`` of every entry of the state dict, kind one of
    ``conv_w``, ``conv_b``, ``norm_w``, ``norm_b``, ``mean``, ``var``,
    ``count``; built on the meta device."""
    with torch.device("meta"):
        model = RAFTStereo(cfg)
    kinds = {}
    for mod_name, mod in model.named_modules(remove_duplicate=False):
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, nn.Conv2d):
            kinds[prefix + "weight"] = "conv_w"
            kinds[prefix + "bias"] = "conv_b"
        elif isinstance(mod, nn.BatchNorm2d):
            kinds.update({prefix + "weight": "norm_w", prefix + "bias": "norm_b",
                          prefix + "running_mean": "mean", prefix + "running_var": "var",
                          prefix + "num_batches_tracked": "count"})
    return [(k, tuple(v.shape), kinds[k]) for k, v in model.state_dict().items()]
