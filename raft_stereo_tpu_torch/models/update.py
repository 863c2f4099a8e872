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

Under a height shard (``space``, a ``parallel.ProcessGrid`` with a space
axis; the JAX package's ``space_mesh``) every map is this rank's rows. The
GRU levels and the motion encoder that the spatial rule admits
(``ops/stream.py:spatial_gru_is_fusable``) run the kernels' spatial entries;
gru16+32 is never co-scheduled and the resident iteration never runs; the
rest (fp32, levels too short for the halo, the mask head, the pools and
resizes between levels) runs plain on rows extended from the neighbours
(``ops/halo.py``): the exchanges XLA's partitioner inserts in the JAX
package. A 3x3 conv reads 1 row past its output, a 7x7 conv 3.

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
from raft_stereo_tpu_torch.ops.halo import run_extended
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


class SepConvGRU(nn.Module):
    """Reference ``SepConvGRU`` (``core/update.py:34-62``): a GRU step with
    1x5 convs (padding (0, 2)), then one with 5x1 convs (padding (2, 0)), on
    ``[h; x]``. Unused by the stereo model, in either package (the JAX
    package's ``apply_sep_conv_gru``)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{suffix}",
                        Conv2d(cin, hidden_dim, k, padding=pad))

    def forward(self, h: torch.Tensor, *x_list: torch.Tensor) -> torch.Tensor:
        x = torch.cat(x_list, dim=-1) if len(x_list) > 1 else x_list[0]
        for convz, convr, convq in ((self.convz1, self.convr1, self.convq1),
                                    (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=-1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], dim=-1)))
            h = (1 - z) * h + z * q
        return h


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


# Rows past its output that each plain module reads on a height shard.
GRU_HALO = 2      # z, r from 3x3 convs of [h; x]; q from a 3x3 conv of r * h
HEAD_HALO = 2     # FlowHead: two 3x3 convs
MOTION_HALO = 5   # the flow branch: 7x7, 3x3, then the 3x3 fusion conv
MASK_HALO = 1     # a 3x3 conv, then a 1x1


def _global_size(t: torch.Tensor, space) -> Tuple[int, int]:
    """The whole map's (H, W) of a map whose rows may be a shard's."""
    ns = 1 if space is None else space.n_space
    return (t.shape[1] * ns, t.shape[2])


class FusedInputs(NamedTuple):
    """Loop-invariant inputs of the kernels, built once per frame. Under a
    height shard a level's ``czrq`` is its extended rows' (or None: the
    level runs plain)."""

    czrq: List[Optional[stream.Czrq]]    # per level, prepare_gru_context_any
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

    def mask_head(self, net0: torch.Tensor, space=None) -> torch.Tensor:
        """Convex-upsampling mask, scaled by 0.25 as in the reference."""
        if space is not None:
            return 0.25 * run_extended(self.mask, MASK_HALO, space, net0)
        return 0.25 * self.mask(net0)

    def prepare_fused(self, inp: Sequence[Sequence[torch.Tensor]],
                      dtype: torch.dtype, *, train: bool = False, space=None,
                      net: Optional[Sequence[torch.Tensor]] = None) -> FusedInputs:
        """The kernels' loop-invariant inputs. In training (``train``) the
        czrq context stays bf16 whatever ``RAFT_LANE_PACK8`` says, as in the
        JAX package; everything here is differentiable torch. Under
        ``space`` each level whose state ``net[i]`` the spatial rule admits
        gets its extended czrq (bf16 always), the others None."""
        grus = self.grus[:self.n_gru_layers]
        if space is not None:
            czrq = [stream.spatial_prepare_gru_context(space, g, c, dtype)
                    if stream.spatial_gru_is_fusable(h, space.n_space) else None
                    for g, c, h in zip(grus, inp, net)]
        else:
            ctx = stream.prepare_gru_context if train else stream.prepare_gru_context_any
            czrq = [ctx(g, c, dtype) for g, c in zip(grus, inp)]
        return FusedInputs(
            czrq=czrq,
            gru=[stream.gru_weights(g, dtype, name)
                 for g, name in zip(grus, ("gru08", "gru16", "gru32"))],
            head=stream.head_weights(self.flow_head, dtype),
            motion=stream.motion_weights(self.encoder, dtype))

    def _gru(self, idx: int, h: torch.Tensor, inp, fused: Optional[FusedInputs],
             *xs: torch.Tensor, space=None) -> torch.Tensor:
        if fused is not None and fused.czrq[idx] is not None:
            if space is not None:
                return stream.fused_conv_gru_spatial(space, fused.gru[idx], h,
                                                     fused.czrq[idx], *xs)[0]
            return stream.fused_conv_gru(fused.gru[idx], h, fused.czrq[idx], *xs)[0]
        gru = self.grus[idx]
        if space is not None:
            return run_extended(lambda h, cz, cr, cq, *xs: gru(h, (cz, cr, cq), *xs),
                                GRU_HALO, space, h, *inp[idx], *xs)
        return gru(h, inp[idx], *xs)

    def gru1632_engaged(self, net: Sequence[torch.Tensor],
                        fused: Optional[FusedInputs], space=None) -> bool:
        """Whether the coarse GRUs run the gru16+32 kernel: three levels, the
        kernels in use (bf16), ``RAFT_FUSE_GRU1632`` on, gru16 and gru32 of
        one hidden width, gru32's map exactly half of gru16's, and no height
        shard (the JAX package's ``space_mesh is None``)."""
        if (fused is None or self.n_gru_layers != 3 or not fuse_gru1632_on()
                or space is not None):
            return False
        h16, h32 = net[1], net[2]
        return (h16.shape[-1] == h32.shape[-1] and h16.shape[1] == 2 * h32.shape[1]
                and h16.shape[2] == 2 * h32.shape[2])

    def step_coarse(self, net: Sequence[torch.Tensor], inp: Sequence[Sequence[torch.Tensor]],
                    fused: Optional[FusedInputs] = None, *, iter32: bool = True,
                    iter16: bool = True, space=None) -> Tuple[torch.Tensor, ...]:
        """The coarse GRUs of one step, gru32 (``iter32``) then gru16
        (``iter16``), those the model has, leaving gru08 as it is: the JAX
        package's update block with ``iter08=False, update=False``. With both
        flags set and the gru16+32 kernel engaged (:meth:`gru1632_engaged`),
        one launch does both; otherwise each runs its own step."""
        net = list(net)
        n = self.n_gru_layers
        if iter32 and iter16 and self.gru1632_engaged(net, fused, space):
            net[1], net[2] = stream.fused_gru1632(
                fused.gru[1], fused.gru[2], net[1], net[2], fused.czrq[1], fused.czrq[2],
                pool2x(net[0]), pool2x(net[1]))
            return tuple(net)
        if iter32 and n == 3:
            net[2] = self._gru(2, net[2], inp, fused, pool2x(net[1], space), space=space)
        if iter16 and n >= 2:
            xs16 = (pool2x(net[0], space),)
            if n == 3:
                xs16 += (interp_align_corners(net[2], _global_size(net[1], space), space),)
            net[1] = self._gru(1, net[1], inp, fused, *xs16, space=space)
        return tuple(net)

    def _delta_flow(self, dx: torch.Tensor) -> torch.Tensor:
        # The kernels leave out conv2.b[0]; the y delta is zeroed by the
        # epipolar projection, so it is never computed.
        dx = dx + self.flow_head.conv2.bias[0]
        return torch.cat([dx, torch.zeros_like(dx)], dim=-1)

    def forward(self, net: Sequence[torch.Tensor], inp: Sequence[Sequence[torch.Tensor]],
                corr: torch.Tensor, flow: torch.Tensor, *,
                fused: Optional[FusedInputs] = None, fuse_motion: bool = True, space=None):
        """One test-mode refinement step, coarse to fine. Returns ``(net,
        delta_flow)``; the mask head is left to the caller, which needs it
        once, after the loop.

        With ``fused`` the GRUs run the kernels, with the FlowHead chained
        onto gru08's, and so does the motion encoder unless ``fuse_motion`` is
        off (a caller-supplied flow_init may carry a nonzero y, whose weights
        the kernel drops).
        """
        net = list(self.step_coarse(net, inp, fused, space=space))
        if space is not None:
            if (fused is not None and fuse_motion
                    and stream.spatial_motion_is_fusable(corr, space.n_space)):
                motion = stream.fused_motion_spatial(space, fused.motion, flow, corr)
            else:
                motion = run_extended(self.encoder, MOTION_HALO, space, flow, corr)
        elif fused is not None and fuse_motion:
            motion = stream.fused_motion(fused.motion, flow, corr)
        else:
            motion = self.encoder(flow, corr)
        xs = (motion,)
        if self.n_gru_layers > 1:
            xs += (interp_align_corners(net[1], _global_size(net[0], space), space),)
        if fused is None or fused.czrq[0] is None:
            net[0] = self._gru(0, net[0], inp, None, *xs, space=space)
            if space is not None:
                return tuple(net), run_extended(self.flow_head, HEAD_HALO, space, net[0])
            return tuple(net), self.flow_head(net[0])
        if space is not None:
            net[0], dx = stream.fused_gru_head_spatial(space, fused.gru[0], fused.head,
                                                       net[0], fused.czrq[0], *xs)
        else:
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
