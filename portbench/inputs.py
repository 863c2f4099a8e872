"""What a run makes from its seed: the weights and the image pairs.

Both are made on the run's device with a ``torch.Generator`` there, in a few
large calls, so that set-up pays no host work that grows with the model or
the frame. The same seed gives the same tensors on the same device and
torch version.

- Weights: every tensor of the reference's state dict
  (``reference.raft_stereo.parameter_layout``), in float32, the type the
  port keeps its parameters in. Convolutions get the JAX package's and the
  port's initialization (Kaiming normal, fan-out, ReLU gain; biases uniform
  in +-1/sqrt(fan-in)); norms scale 1, shift 0, mean 0, variance 1. The flow
  head's last conv is scaled by 1/50, so that an iteration moves the
  coordinates by a pixel or so, as a trained model's does.
- Pairs: a copy of the arithmetic of ``data/synthetic.py:synthetic_pair``:
  a left image of smooth seeded texture under uniform noise, a smooth
  disparity field in [0, max_disp] px, and the right image the left one
  sampled at ``x + d``, both rounded to uint8.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.raft_stereo import parameter_layout

# Streams drawn from one run seed, each with a generator of its own.
STREAMS = ("weights", "pairs", "order", "sample")


def stream_seeds(seed: int) -> Dict[str, int]:
    """A 63-bit seed for each of :data:`STREAMS`, from the run's seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS), dtype=np.uint64)
    return {name: int(s) >> 1 for name, s in zip(STREAMS, state)}


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded state dict in the reference's names, on ``device``."""
    layout = parameter_layout(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    conv_w = [(n, s) for n, s, k in layout if k == "conv_w"]
    conv_b = [(n, s) for n, s, k in layout if k == "conv_b"]
    normal = torch.randn(sum(math.prod(s) for _, s in conv_w), generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(s) for _, s in conv_b), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in conv_w:
        cout, _, kh, kw = shape
        size = math.prod(shape)
        out[name] = normal[at:at + size].view(shape) * math.sqrt(2.0 / (cout * kh * kw))
        at += size
    fan_in = {n[:-len("weight")]: s[1] * s[2] * s[3] for n, s in conv_w}
    at = 0
    for name, shape in conv_b:
        size = math.prod(shape)
        bound = 1.0 / math.sqrt(fan_in[name[:-len("bias")]])
        out[name] = (uniform[at:at + size].view(shape) * 2 - 1) * bound
        at += size
    fill = {"norm_w": 1.0, "norm_b": 0.0, "mean": 0.0, "var": 1.0}
    for name, shape, kind in layout:
        if kind in fill:
            out[name] = torch.full(shape, fill[kind], device=device)
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    for key in ("update_block.flow_head.conv2.weight", "update_block.flow_head.conv2.bias"):
        out[key] = out[key] * 0.02
    return out


def _smooth(gen, h: int, w: int, cells: int, device) -> torch.Tensor:
    """A smooth field in [0, 1]: bilinear upsampling of a coarse random grid."""
    gh, gw = max(2, h // cells), max(2, w // cells)
    grid = torch.rand((gh, gw), generator=gen, device=device, dtype=torch.float64)
    ys = torch.linspace(0, gh - 1, h, device=device, dtype=torch.float64)
    xs = torch.linspace(0, gw - 1, w, device=device, dtype=torch.float64)
    y0 = ys.long().clamp(max=gh - 2)
    x0 = xs.long().clamp(max=gw - 2)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    g00, g01 = grid[y0][:, x0], grid[y0][:, x0 + 1]
    g10, g11 = grid[y0 + 1][:, x0], grid[y0 + 1][:, x0 + 1]
    return (1 - fy) * ((1 - fx) * g00 + fx * g01) + fy * ((1 - fx) * g10 + fx * g11)


def make_pairs(n: int, h: int, w: int, max_disp: float, seed: int,
               device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``n`` pairs of uint8 (H, W, 3) images on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.arange(h, device=device)[:, None]
    pairs = []
    for _ in range(n):
        texture = torch.stack([_smooth(gen, h, w, c, device) for c in (8, 24, 64)], dim=-1)
        noise = torch.rand((h, w, 3), generator=gen, device=device, dtype=torch.float64)
        left = 255.0 * (0.55 * texture + 0.45 * noise)
        disp = max_disp * _smooth(gen, h, w, 96, device).float().double()
        src = (torch.arange(w, device=device)[None, :] + disp).clamp(0, w - 1)
        x0 = torch.floor(src).long().clamp(max=w - 2)
        frac = (src - x0)[..., None]
        right = left[rows, x0] * (1 - frac) + left[rows, x0 + 1] * frac
        pairs.append(tuple(torch.round(x).clamp(0, 255).to(torch.uint8) for x in (left, right)))
    return pairs
