"""Per-iteration refinement: motion encoder, ConvGRU cascade, flow and mask
heads (reference ``core/update.py``), NHWC.

The modules' own ``forward`` methods are the JAX package's plain
formulation (``models/update.py``): split gate convs summed in fp32 and
rounded once. In bf16 test mode the update block instead routes the GRUs,
the FlowHead and the motion encoder through the hand-written kernels of
:mod:`raft_stereo_tpu_torch.ops.stream` and :mod:`~raft_stereo_tpu_torch.
ops.resident`, which round where the JAX package's Pallas kernels do; the
loop-invariant inputs those take are built once per frame by
:meth:`BasicMultiUpdateBlock.prepare_fused` (under ``RAFT_LANE_PACK8`` the
czrq context as int8 containers, which every step passes through as is).
As in the JAX package, gru32 and gru16 then run as one kernel
(``RAFT_FUSE_GRU1632``), and the caller
may take the resident iteration (:meth:`BasicMultiUpdateBlock.
step_resident`, ``RAFT_FUSE_ITER``); both give the serial kernels' bits.

Hidden-dim convention as in the reference: ``hidden_dims[2]`` is the finest
scale (gru08), ``hidden_dims[0]`` the coarsest.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from raft_stereo_tpu_torch.config import RAFTStereoConfig, fuse_gru1632_on
from raft_stereo_tpu_torch.models.layers import Conv2d
from raft_stereo_tpu_torch.ops import stream
from raft_stereo_tpu_torch.ops.basic import conv2d
from raft_stereo_tpu_torch.ops.pooling import pool2x
from raft_stereo_tpu_torch.ops.resident import fused_iter
from raft_stereo_tpu_torch.ops.resize import interp_align_corners


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256, output_dim: int = 2):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = Conv2d(hidden_dim, output_dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int, kernel_size: int = 3):
        super().__init__()
        cin = hidden_dim + input_dim
        pad = kernel_size // 2
        self.convz = Conv2d(cin, hidden_dim, kernel_size, padding=pad)
        self.convr = Conv2d(cin, hidden_dim, kernel_size, padding=pad)
        self.convq = Conv2d(cin, hidden_dim, kernel_size, padding=pad)

    def forward(self, h: torch.Tensor, context: Sequence[torch.Tensor],
                *x_list: torch.Tensor) -> torch.Tensor:
        """context = (cz, cr, cq) additive gate biases. The z and r h-side
        convs share one fp32 accumulator with the x side and round once."""
        cz, cr, cq = context
        ch = h.shape[-1]
        pad = self.convz.padding
        x = torch.cat(x_list, dim=-1)
        convs = (self.convz, self.convr, self.convq)
        wx = torch.cat([c.weight[:, ch:] for c in convs], dim=0)
        ax = conv2d(x, wx, padding=pad, out_dtype=torch.float32)
        wh = torch.cat([c.weight[:, :ch] for c in convs[:2]], dim=0)
        bh = torch.cat([self.convz.bias, self.convr.bias])
        ah = conv2d(h, wh, bh, padding=pad, out_dtype=torch.float32)
        zr = (ah + ax[..., :2 * ch]).to(h.dtype)
        z = torch.sigmoid(zr[..., :ch] + cz)
        r = torch.sigmoid(zr[..., ch:] + cr)
        aq = conv2d(r * h, self.convq.weight[:, :ch], self.convq.bias, padding=pad,
                    out_dtype=torch.float32)
        q = torch.tanh((aq + ax[..., 2 * ch:]).to(h.dtype) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = Conv2d(cor_planes, 64, 1, padding=0)
        self.convc2 = Conv2d(64, 64, 3, padding=1)
        self.convf1 = Conv2d(2, 64, 7, padding=3)
        self.convf2 = Conv2d(64, 64, 3, padding=1)
        self.conv = Conv2d(64 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=-1),
                                   out_dtype=torch.float32).to(cor.dtype))
        return torch.cat([out, flow.to(out.dtype)], dim=-1)


class FusedInputs(NamedTuple):
    """Loop-invariant inputs of the kernels, built once per frame."""

    czrq: List[stream.Czrq]              # per level, prepare_gru_context_any
    gru: List[stream.GruWeights]         # per level
    head: stream.HeadWeights
    motion: stream.MotionWeights


class BasicMultiUpdateBlock(nn.Module):
    def __init__(self, cfg: RAFTStereoConfig):
        super().__init__()
        hd = cfg.hidden_dims
        n = cfg.n_gru_layers
        self.n_gru_layers = n
        encoder_output_dim = 128
        self.encoder = BasicMotionEncoder(cfg.cor_planes)
        self.gru08 = ConvGRU(hd[2], encoder_output_dim + hd[1] * (n > 1))
        self.gru16 = ConvGRU(hd[1], hd[0] * (n == 3) + hd[2])
        self.gru32 = ConvGRU(hd[0], hd[1])
        self.flow_head = FlowHead(hd[2], hidden_dim=256, output_dim=2)
        factor = cfg.downsample_factor
        self.mask = nn.Sequential(Conv2d(hd[2], 256, 3, padding=1), nn.ReLU(),
                                  Conv2d(256, factor * factor * 9, 1, padding=0))

    @property
    def grus(self) -> Tuple[ConvGRU, ConvGRU, ConvGRU]:
        return (self.gru08, self.gru16, self.gru32)

    def mask_head(self, net0: torch.Tensor) -> torch.Tensor:
        """Convex-upsampling mask, scaled by 0.25 as in the reference."""
        return 0.25 * self.mask(net0)

    def prepare_fused(self, inp: Sequence[Sequence[torch.Tensor]],
                      dtype: torch.dtype) -> FusedInputs:
        grus = self.grus[:self.n_gru_layers]
        return FusedInputs(
            czrq=[stream.prepare_gru_context_any(g, c, dtype) for g, c in zip(grus, inp)],
            gru=[stream.gru_weights(g, dtype, name)
                 for g, name in zip(grus, ("gru08", "gru16", "gru32"))],
            head=stream.head_weights(self.flow_head, dtype),
            motion=stream.motion_weights(self.encoder, dtype))

    def _gru(self, idx: int, h: torch.Tensor, inp, fused: Optional[FusedInputs],
             *xs: torch.Tensor) -> torch.Tensor:
        if fused is not None:
            return stream.fused_conv_gru(fused.gru[idx], h, fused.czrq[idx], *xs)[0]
        return self.grus[idx](h, inp[idx], *xs)

    def gru1632_engaged(self, net: Sequence[torch.Tensor],
                        fused: Optional[FusedInputs]) -> bool:
        """Whether the coarse GRUs run the gru16+32 kernel: three levels, the
        kernels in use (bf16), ``RAFT_FUSE_GRU1632`` on, gru16 and gru32 of
        one hidden width, and gru32's map exactly half of gru16's."""
        if fused is None or self.n_gru_layers != 3 or not fuse_gru1632_on():
            return False
        h16, h32 = net[1], net[2]
        return (h16.shape[-1] == h32.shape[-1] and h16.shape[1] == 2 * h32.shape[1]
                and h16.shape[2] == 2 * h32.shape[2])

    def step_coarse(self, net: Sequence[torch.Tensor], inp: Sequence[Sequence[torch.Tensor]],
                    fused: Optional[FusedInputs] = None, *, iter32: bool = True,
                    iter16: bool = True) -> Tuple[torch.Tensor, ...]:
        """The coarse GRUs of one step, gru32 (``iter32``) then gru16
        (``iter16``), those the model has, leaving gru08 as it is: the JAX
        package's update block with ``iter08=False, update=False``. With both
        flags set and the gru16+32 kernel engaged (:meth:`gru1632_engaged`),
        one launch does both; otherwise each runs its own step."""
        net = list(net)
        n = self.n_gru_layers
        if iter32 and iter16 and self.gru1632_engaged(net, fused):
            net[1], net[2] = stream.fused_gru1632(
                fused.gru[1], fused.gru[2], net[1], net[2], fused.czrq[1], fused.czrq[2],
                pool2x(net[0]), pool2x(net[1]))
            return tuple(net)
        if iter32 and n == 3:
            net[2] = self._gru(2, net[2], inp, fused, pool2x(net[1]))
        if iter16 and n >= 2:
            xs16 = (pool2x(net[0]),)
            if n == 3:
                xs16 += (interp_align_corners(net[2], net[1].shape[1:3]),)
            net[1] = self._gru(1, net[1], inp, fused, *xs16)
        return tuple(net)

    def _delta_flow(self, dx: torch.Tensor) -> torch.Tensor:
        # The kernels leave out conv2.b[0]; the y delta is zeroed by the
        # epipolar projection, so it is never computed.
        dx = dx + self.flow_head.conv2.bias[0]
        return torch.cat([dx, torch.zeros_like(dx)], dim=-1)

    def forward(self, net: Sequence[torch.Tensor], inp: Sequence[Sequence[torch.Tensor]],
                corr: torch.Tensor, flow: torch.Tensor, *,
                fused: Optional[FusedInputs] = None, fuse_motion: bool = True):
        """One test-mode refinement step, coarse to fine. Returns ``(net,
        delta_flow)``; the mask head is left to the caller, which needs it
        once, after the loop.

        With ``fused`` the GRUs run the kernels, with the FlowHead chained
        onto gru08's, and so does the motion encoder unless ``fuse_motion`` is
        off (a caller-supplied flow_init may carry a nonzero y, whose weights
        the kernel drops).
        """
        net = list(self.step_coarse(net, inp, fused))
        if fused is not None and fuse_motion:
            motion = stream.fused_motion(fused.motion, flow, corr)
        else:
            motion = self.encoder(flow, corr)
        xs = (motion,)
        if self.n_gru_layers > 1:
            xs += (interp_align_corners(net[1], net[0].shape[1:3]),)
        if fused is None:
            net[0] = self._gru(0, net[0], inp, None, *xs)
            return tuple(net), self.flow_head(net[0])
        net[0], dx = stream.fused_conv_gru(fused.gru[0], net[0], fused.czrq[0], *xs,
                                           head=fused.head)
        return tuple(net), self._delta_flow(dx)

    def step_resident(self, net: Sequence[torch.Tensor], inp: Sequence[Sequence[torch.Tensor]],
                      corr_ops, coords_x: torch.Tensor, flow: torch.Tensor, *,
                      fused: FusedInputs):
        """:meth:`forward` with the lookup, the motion encoder and gru08 with
        the head in the resident iteration kernel, which gathers the
        correlation taps from ``corr_ops`` at ``coords_x`` itself. The
        upsampled gru16 state stays outside, as in the JAX package. Same
        return, same bits."""
        net = list(self.step_coarse(net, inp, fused))
        xs2 = ((interp_align_corners(net[1], net[0].shape[1:3]),)
               if self.n_gru_layers > 1 else ())
        net[0], dx = fused_iter(fused.motion, fused.gru[0], fused.head, corr_ops, net[0],
                                fused.czrq[0], coords_x, flow, *xs2)
        return tuple(net), self._delta_flow(dx)
