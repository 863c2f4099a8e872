"""The refinement loop's kernels: the ConvGRU step (optionally with the
FlowHead), the motion encoder, and gru32 + gru16 co-scheduled.

Counterpart of the JAX package's ``ops/pallas_stream.py``. Each kernel has
a wrapper that launches ``csrc/conv_gru.cu``, ``csrc/motion.cu`` or
``csrc/gru1632.cu`` on CUDA tensors, and a plain torch version with the
same signature and the same rounding points that the wrapper runs on CPU
tensors. There is no other route between them: a CUDA tensor the kernel
does not take raises.

The kernels round where the Pallas kernels do, which is not where the plain
torch modules of ``models/update.py`` round:

- GRU: the gate biases are folded into the context once per frame and
  rounded to bf16 (:func:`prepare_gru_context`); z, r, r*h and q round to
  bf16 at their nonlinearities; ``h' = (1 - z) * h + z * q`` runs in bf16.
- FlowHead: ``f1 = bf16(relu(conv1(h') + b1))``; the x delta is
  ``conv2(f1)[..., 0]`` in fp32 without ``conv2.b[0]``, which the caller adds.
- Motion: ``c1``, ``f1``, ``[c2|f2]`` and the fused output round to bf16
  after their relus; convf1's flow-y weights are dropped (flow y is 0).

Weights are converted once per frame into the kernels' layout, in the
compute dtype (:func:`gru_weights`, :func:`head_weights`,
:func:`motion_weights`): K-major ``(9, Cout, Cin)`` matrices (the ``*_k``
fields), which the loop engine (``csrc/loop_conv_sm90.cuh``: every 3x3 conv
of the loop, in the serial launches and in the gru16+32 and resident
kernels) and the plain versions read alike.

Under ``RAFT_LANE_PACK8`` the czrq context is an int8 lane container
(:func:`prepare_gru_context_any`, ``corr/reg_cuda.py:Lane8``): the GRU
kernels and their plain versions add ``q * scale`` (the product rounded to
fp32 first, then added to the fp32 accumulator) where they add the bf16
czrq otherwise, and the launches count as the ``lane8`` variant
(``conv_gru:<level>:lane8``, ``gru1632:lane8``).

Training: :func:`fused_conv_gru`, :func:`fused_motion` and
:func:`fused_gru1632` are differentiable (``ops/grad.py``): the forward is
the kernel, the backward autograd through the plain version recomputed from
the saved inputs, the JAX package's XLA oracle. Their gradients reach the
module parameters through the layout builders (:func:`gru_weights`,
:func:`head_weights`, :func:`motion_weights`, :func:`prepare_gru_context`),
which are plain differentiable torch. The int8 lane variants have no
backward and raise under grad.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch import kernels
from raft_stereo_tpu_torch.config import lane_pack8_on
from raft_stereo_tpu_torch.corr.reg_cuda import Lane8, dequantize_feature8, quantize_feature8
from raft_stereo_tpu_torch.ops.grad import recompute, refuse_grad
from raft_stereo_tpu_torch.ops.resize import interp_align_corners, lerp_taps

Czrq = Union[torch.Tensor, Lane8]  # the folded context, or its int8 container

_BRANCH = 64  # csrc/stages.cuh motion_s2_loop: the block-diagonal stage's column tiles


def _kmajor(w: torch.Tensor) -> torch.Tensor:
    """OIHW 3x3 weight -> (9, Cout, Cin): the loop engine's K-major layout."""
    cout, cin = w.shape[:2]
    return w.permute(2, 3, 0, 1).reshape(9, cout, cin)


def _conv9(x: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """fp32 3x3 conv of NHWC ``x`` with a K-major (9, Cout, Cin) matrix,
    zero padding 1: the kernels' fp32 accumulator."""
    cout, cin = wk.shape[1:]
    w = wk.float().reshape(3, 3, cout, cin).permute(2, 3, 0, 1).contiguous()
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w, None, 1, 1)
    return out.permute(0, 2, 3, 1)


class GruWeights(NamedTuple):
    w_gate_k: torch.Tensor  # (9, 3ch, ch + cx): [wz | wr | wq] over [h; x]
    w_q_k: torch.Tensor     # (9, ch, ch): wq over h (applied to r*h)
    ch: int
    level: str              # the GRU's name, keys its launch count


class HeadWeights(NamedTuple):
    w1_k: torch.Tensor  # (9, nh, ch): conv1
    b1: torch.Tensor    # (nh,) fp32
    w2_k: torch.Tensor  # (9, 1, nh): conv2's x output
    nh: int


class MotionWeights(NamedTuple):
    wc1: torch.Tensor   # (ccorr, n1): convc1, 1x1
    wf1: torch.Tensor   # (49, nf): convf1 over flow x, taps row-major
    b1: torch.Tensor    # (n1 + nf,) fp32
    b2: torch.Tensor    # (ns,) fp32
    bf: torch.Tensor    # (cf,) fp32
    w2_k: torch.Tensor  # (9, ns, ns): block-diagonal [convc2, convf2]
    wf_k: torch.Tensor  # (9, cf, ns): the fusion conv
    n1: int
    nf: int
    cf: int


def gru_weights(gru, dtype: torch.dtype, level: str = "gru") -> GruWeights:
    """Kernel-layout weights of a ConvGRU module (convz/convr/convq over
    ``[h; x]``). The kernel's launches with them count under
    ``conv_gru:<level>``."""
    ch = gru.convz.weight.shape[0]
    w_gate_k = torch.cat([_kmajor(c.weight) for c in (gru.convz, gru.convr, gru.convq)],
                         dim=1).to(dtype).contiguous()
    return GruWeights(w_gate_k, w_gate_k[:, 2 * ch:, :ch].contiguous(), ch, level)


def head_weights(head, dtype: torch.dtype) -> HeadWeights:
    """Kernel-layout weights of a FlowHead (conv1 3x3 + relu, conv2 3x3)."""
    return HeadWeights(_kmajor(head.conv1.weight).to(dtype).contiguous(),
                       head.conv1.bias.float().contiguous(),
                       _kmajor(head.conv2.weight[:1]).to(dtype).contiguous(),
                       head.conv1.weight.shape[0])


def motion_weights(enc, dtype: torch.dtype) -> MotionWeights:
    """Kernel-layout weights of a BasicMotionEncoder."""
    n1 = enc.convc1.weight.shape[0]
    nf = enc.convf1.weight.shape[0]
    ns = n1 + nf
    wc1 = enc.convc1.weight[:, :, 0, 0].t().to(dtype).contiguous()
    wf1 = enc.convf1.weight[:, 0].reshape(nf, 49).t().to(dtype).contiguous()
    b1 = torch.cat([enc.convc1.bias, enc.convf1.bias]).float()
    b2 = torch.cat([enc.convc2.bias, enc.convf2.bias]).float()
    w2_k = torch.zeros(9, ns, ns, dtype=dtype, device=wc1.device)
    w2_k[:, :n1, :n1] = _kmajor(enc.convc2.weight).to(dtype)
    w2_k[:, n1:, n1:] = _kmajor(enc.convf2.weight).to(dtype)
    return MotionWeights(wc1, wf1, b1, b2, enc.conv.bias.float().contiguous(), w2_k,
                         _kmajor(enc.conv.weight).to(dtype).contiguous(), n1, nf,
                         enc.conv.weight.shape[0])


def prepare_gru_context(gru, context: Sequence[torch.Tensor],
                        dtype: torch.dtype) -> torch.Tensor:
    """Fold the gate conv biases into the (cz, cr, cq) context and round
    once: ``czrq = dtype(concat(context) + [bz | br | bq])``. Built once per
    frame, outside the loop."""
    bias = torch.cat([gru.convz.bias, gru.convr.bias, gru.convq.bias]).float()
    return (torch.cat(list(context), dim=-1).float() + bias).to(dtype).contiguous()


def prepare_gru_context_any(gru, context: Sequence[torch.Tensor], dtype: torch.dtype) -> Czrq:
    """:func:`prepare_gru_context`, and under ``RAFT_LANE_PACK8`` its
    result quantized once to an int8 container (per-sample scale)."""
    czrq = prepare_gru_context(gru, context, dtype)
    return quantize_feature8(czrq) if lane_pack8_on() else czrq


def _czrq_f32(czrq: Czrq) -> torch.Tensor:
    """The context the gates add, in fp32."""
    return dequantize_feature8(czrq, torch.float32) if isinstance(czrq, Lane8) else czrq.float()


def _czrq_args(name: str, czrq: Czrq, shape, device):
    """A czrq operand as the kernels take it, checked: its pointer, 1 for
    an int8 container (0 for bf16) and the container's scale pointer."""
    if isinstance(czrq, Lane8):
        _check_nhwc(name, czrq.q, shape, torch.int8, device)
        _check_nhwc(f"{name}.scale", czrq.scale, shape[:1], torch.float32, device)
        return czrq.q.data_ptr(), 1, czrq.scale.data_ptr()
    _check_nhwc(name, czrq, shape, torch.bfloat16, device)
    return czrq.data_ptr(), 0, None


def _count(kernel: str, lane8: int) -> None:
    if lane8:
        kernels.count_launch(kernel, "lane8")
    else:
        kernels.launches[kernel] += 1


# -- ConvGRU (+ FlowHead): kernel 2 ------------------------------------------


def conv_gru_plain(w: GruWeights, h: torch.Tensor, czrq: Czrq,
                   *x_list: torch.Tensor, head: Optional[HeadWeights] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version of :func:`fused_conv_gru`."""
    ch, dt = w.ch, h.dtype
    x = torch.cat(x_list, dim=-1)
    ctx = _czrq_f32(czrq)
    zr = _conv9(torch.cat([h, x], dim=-1), w.w_gate_k[:, :2 * ch]) + ctx[..., :2 * ch]
    z = torch.sigmoid(zr[..., :ch]).to(dt)
    r = torch.sigmoid(zr[..., ch:]).to(dt)
    rh = r * h
    aqx = _conv9(x, w.w_gate_k[:, 2 * ch:, ch:]) + ctx[..., 2 * ch:]
    q = torch.tanh(_conv9(rh, w.w_q_k) + aqx).to(dt)
    h_new = (1 - z) * h + z * q
    if head is None:
        return h_new, None
    f1 = torch.relu(_conv9(h_new, head.w1_k) + head.b1).to(dt)
    return h_new, _conv9(f1, head.w2_k)


def _check_nhwc(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _head_leaves(head: Optional[HeadWeights]) -> list:
    return [] if head is None else [head.w1_k, head.b1, head.w2_k]


def fused_conv_gru(w: GruWeights, h: torch.Tensor, czrq: Czrq,
                   *x_list: torch.Tensor, head: Optional[HeadWeights] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`conv_gru_launch`, differentiable: its backward is autograd
    through :func:`conv_gru_plain` (the JAX package's ``fused_conv_gru`` /
    ``fused_gru_head`` oracle). Same arguments and return."""
    leaves = [h, czrq, *x_list, w.w_gate_k, w.w_q_k, *_head_leaves(head)]
    if isinstance(czrq, Lane8):
        refuse_grad(f"conv_gru:{w.level}:lane8", leaves)
        return conv_gru_launch(w, h, czrq, *x_list, head=head)
    nx = len(x_list)

    def unpack(leaves):
        hd = None if head is None else HeadWeights(*leaves[4 + nx:7 + nx], head.nh)
        return (GruWeights(leaves[2 + nx], leaves[3 + nx], w.ch, w.level), leaves[0],
                leaves[1], leaves[2:2 + nx], hd)

    def run(*leaves):
        gw, hh, cz, xs, hd = unpack(leaves)
        out = conv_gru_launch(gw, hh, cz, *xs, head=hd)
        return out if hd is not None else out[0]

    def plain(*leaves):
        gw, hh, cz, xs, hd = unpack(leaves)
        out = conv_gru_plain(gw, hh, cz, *xs, head=hd)
        return out if hd is not None else out[0]

    out = recompute(run, plain, leaves, single=head is None)
    return tuple(out) if head is not None else (out, None)


def conv_gru_launch(w: GruWeights, h: torch.Tensor, czrq: Czrq,
                    *x_list: torch.Tensor, head: Optional[HeadWeights] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One ConvGRU step on NHWC tensors; with ``head``, the FlowHead's x
    delta too (the JAX package's ``fused_conv_gru`` and ``fused_gru_head``).
    Returns ``(h', dx)`` with ``dx`` (B, H, W, 1) fp32 without
    ``conv2.b[0]``, or ``None`` without the head.

    h: (B, H, W, ch); czrq: (B, H, W, 3ch) from :func:`prepare_gru_context`,
    or its int8 container from :func:`prepare_gru_context_any`; x_list: one
    to three (B, H, W, c_i) inputs, never concatenated.
    """
    refuse_grad(f"conv_gru:{w.level}", h, czrq, x_list, w.w_gate_k, w.w_q_k,
                _head_leaves(head))
    if h.device.type == "cpu":
        return conv_gru_plain(w, h, czrq, *x_list, head=head)
    b, hh, ww, ch = h.shape
    dev, dt = h.device, torch.bfloat16
    if not 1 <= len(x_list) <= 3:
        raise ValueError(f"the GRU kernel takes 1..3 x parts, got {len(x_list)}")
    cxs = [x.shape[-1] for x in x_list]
    if ch != w.ch or any(c % 32 for c in [ch, *cxs]):
        raise ValueError(f"GRU kernel channels must be multiples of 32: ch={ch}, x={cxs}")
    _check_nhwc("h", h, (b, hh, ww, ch), dt, dev)
    czrq_ptr, lane8, scale_ptr = _czrq_args("czrq", czrq, (b, hh, ww, 3 * ch), dev)
    for i, (x, c) in enumerate(zip(x_list, cxs)):
        _check_nhwc(f"x_list[{i}]", x, (b, hh, ww, c), dt, dev)
    _check_nhwc("w_gate_k", w.w_gate_k, (9, 3 * ch, ch + sum(cxs)), dt, dev)
    _check_nhwc("w_q_k", w.w_q_k, (9, ch, ch), dt, dev)
    z = torch.empty_like(h)
    rh = torch.empty_like(h)
    aqx = torch.empty(h.shape, dtype=torch.float32, device=dev)
    h_out = torch.empty_like(h)
    parts = [(x.data_ptr(), c) for x, c in zip(x_list, cxs)] + [(None, 0)] * (3 - len(cxs))
    w1 = b1 = w2 = f1 = dx = None
    nh = 0
    if head is not None:
        nh = head.nh
        if nh % 32:
            raise ValueError(f"FlowHead hidden width must be a multiple of 32, got {nh}")
        _check_nhwc("head.w1_k", head.w1_k, (9, nh, ch), dt, dev)
        _check_nhwc("head.b1", head.b1, (nh,), torch.float32, dev)
        _check_nhwc("head.w2_k", head.w2_k, (9, 1, nh), dt, dev)
        f1 = torch.empty((b, hh, ww, nh), dtype=dt, device=dev)
        dx = torch.empty((b, hh, ww, 1), dtype=torch.float32, device=dev)
        w1, b1, w2 = head.w1_k.data_ptr(), head.b1.data_ptr(), head.w2_k.data_ptr()
    fn = kernels.entry("conv_gru")
    kernels.check("conv_gru", fn(
        h.data_ptr(), czrq_ptr, lane8, scale_ptr, parts[0][0], parts[0][1], parts[1][0],
        parts[1][1], parts[2][0], parts[2][1], b, hh, ww, ch, w.w_gate_k.data_ptr(),
        w.w_q_k.data_ptr(), z.data_ptr(), rh.data_ptr(), aqx.data_ptr(),
        h_out.data_ptr(), w1, b1, w2, nh, None if f1 is None else f1.data_ptr(),
        None if dx is None else dx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    _count(f"conv_gru:{w.level}", lane8)
    return h_out, dx


# -- motion encoder: kernel 3 -------------------------------------------------


def motion_plain(w: MotionWeights, flow: torch.Tensor,
                 corr: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`fused_motion`."""
    dt = corr.dtype
    flow = flow.to(dt)
    c1 = torch.relu(corr.float() @ w.wc1.float() + w.b1[:w.n1])
    wf1 = w.wf1.float().t().reshape(w.nf, 1, 7, 7)
    f1 = F.conv2d(flow[..., :1].float().permute(0, 3, 1, 2), wf1, None, 1, 3)
    f1 = torch.relu(f1.permute(0, 2, 3, 1) + w.b1[w.n1:])
    s1 = torch.cat([c1.to(dt), f1.to(dt)], dim=-1)
    s2 = torch.relu(_conv9(s1, w.w2_k) + w.b2).to(dt)
    out = torch.relu(_conv9(s2, w.wf_k) + w.bf).to(dt)
    return torch.cat([out, flow], dim=-1)


def _motion_leaves(w: MotionWeights) -> list:
    return [w.wc1, w.wf1, w.b1, w.b2, w.bf, w.w2_k, w.wf_k]


def fused_motion(w: MotionWeights, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """:func:`motion_launch`, differentiable through :func:`motion_plain`
    (the JAX package's ``fused_motion`` oracle)."""

    def weights(leaves):
        return MotionWeights(*leaves[2:], w.n1, w.nf, w.cf)

    return recompute(lambda *lv: motion_launch(weights(lv), lv[0], lv[1]),
                     lambda *lv: motion_plain(weights(lv), lv[0], lv[1]),
                     [flow, corr, *_motion_leaves(w)], single=True)


def motion_launch(w: MotionWeights, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """Motion features (B, H, W, cf + 2): the fused 126 channels, then the
    raw 2-channel flow. flow: (B, H, W, 2) with y == 0; corr: (B, H, W, L(2r+1))."""
    refuse_grad("motion", flow, corr, _motion_leaves(w))
    if corr.device.type == "cpu":
        return motion_plain(w, flow, corr)
    b, hh, ww, ccorr = corr.shape
    dev, dt = corr.device, torch.bfloat16
    if w.n1 % _BRANCH or w.nf % _BRANCH:
        raise ValueError(f"motion kernel branch widths must be multiples of {_BRANCH}, "
                         f"got {w.n1}, {w.nf}")
    ns = w.n1 + w.nf
    _check_nhwc("corr", corr, (b, hh, ww, ccorr), dt, dev)
    _check_nhwc("flow", flow, (b, hh, ww, 2), dt, dev)
    _check_nhwc("wc1", w.wc1, (ccorr, w.n1), dt, dev)
    _check_nhwc("wf1", w.wf1, (49, w.nf), dt, dev)
    _check_nhwc("b1", w.b1, (ns,), torch.float32, dev)
    _check_nhwc("w2_k", w.w2_k, (9, ns, ns), dt, dev)
    _check_nhwc("b2", w.b2, (ns,), torch.float32, dev)
    _check_nhwc("wf_k", w.wf_k, (9, w.cf, ns), dt, dev)
    _check_nhwc("bf", w.bf, (w.cf,), torch.float32, dev)
    s1 = torch.empty((b, hh, ww, ns), dtype=dt, device=dev)
    s2 = torch.empty_like(s1)
    out = torch.empty((b, hh, ww, w.cf + 2), dtype=dt, device=dev)
    fn = kernels.entry("motion")
    kernels.check("motion", fn(
        corr.data_ptr(), ccorr, flow.data_ptr(), b, hh, ww, w.wc1.data_ptr(),
        w.wf1.data_ptr(), w.b1.data_ptr(), w.n1, w.nf, w.w2_k.data_ptr(),
        w.b2.data_ptr(), w.wf_k.data_ptr(), w.bf.data_ptr(), w.cf, s1.data_ptr(),
        s2.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    kernels.launches["motion"] += 1
    return out


# -- gru32 + gru16 co-scheduled: kernel 4 -------------------------------------


def gru1632_plain(w16: GruWeights, w32: GruWeights, h16: torch.Tensor,
                  h32: torch.Tensor, czrq16: Czrq, czrq32: Czrq,
                  x0p: torch.Tensor, x1p: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`fused_gru1632`: the gru32 step, the
    aligned-corners resize of its new state to gru16's size, the gru16
    step."""
    h32n, _ = conv_gru_plain(w32, h32, czrq32, x1p)
    up = interp_align_corners(h32n, tuple(h16.shape[1:3]))
    h16n, _ = conv_gru_plain(w16, h16, czrq16, x0p, up)
    return h16n, h32n


def fused_gru1632(w16: GruWeights, w32: GruWeights, h16: torch.Tensor,
                  h32: torch.Tensor, czrq16: Czrq, czrq32: Czrq,
                  x0p: torch.Tensor, x1p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gru1632_launch`, differentiable through :func:`gru1632_plain`
    (the JAX package's ``fused_gru1632`` oracle)."""
    if isinstance(czrq16, Lane8) or isinstance(czrq32, Lane8):
        refuse_grad("gru1632:lane8", h16, h32, x0p, x1p, w16.w_gate_k, w16.w_q_k,
                    w32.w_gate_k, w32.w_q_k)
        return gru1632_launch(w16, w32, h16, h32, czrq16, czrq32, x0p, x1p)

    def args(lv):
        return (GruWeights(lv[6], lv[7], w16.ch, w16.level),
                GruWeights(lv[8], lv[9], w32.ch, w32.level), *lv[:6])

    return recompute(lambda *lv: gru1632_launch(*args(lv)),
                     lambda *lv: gru1632_plain(*args(lv)),
                     [h16, h32, czrq16, czrq32, x0p, x1p, w16.w_gate_k, w16.w_q_k,
                      w32.w_gate_k, w32.w_q_k])


def gru1632_launch(w16: GruWeights, w32: GruWeights, h16: torch.Tensor,
                   h32: torch.Tensor, czrq16: Czrq, czrq32: Czrq,
                   x0p: torch.Tensor, x1p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two coarse GRU steps in one launch (the JAX package's
    ``fused_gru1632``): ``(h16', h32')`` with
    ``h32' = gru32(h32, czrq32, x1p)`` and
    ``h16' = gru16(h16, czrq16, x0p, interp_align_corners(h32'))``, the
    resize built inside the kernel, each value once, into a scratch map.
    Bit for bit the serial route's: :func:`fused_conv_gru` twice with the
    resize between.

    h16: (B, H16, W16, ch); h32: (B, H32, W32, ch); x0p: (B, H16, W16, cx0),
    pool2x of the finer state; x1p: (B, H32, W32, ch), pool2x(h16). The two
    czrq are both bf16 or both int8 containers.
    """
    refuse_grad("gru1632", h16, h32, czrq16, czrq32, x0p, x1p, w16.w_gate_k, w16.w_q_k,
                w32.w_gate_k, w32.w_q_k)
    if h16.device.type == "cpu":
        return gru1632_plain(w16, w32, h16, h32, czrq16, czrq32, x0p, x1p)
    b, hh16, ww16, ch = h16.shape
    hh32, ww32 = h32.shape[1:3]
    cx0 = x0p.shape[-1]
    dev, dt = h16.device, torch.bfloat16
    if ch != w16.ch or ch != w32.ch or ch % 32 or cx0 % 32:
        raise ValueError(f"gru1632 kernel: both levels need one hidden width, a "
                         f"multiple of 32: gru16 {w16.ch}, gru32 {w32.ch}, h {ch}, x0 {cx0}")
    c16, lane8, s16 = _czrq_args("czrq16", czrq16, (b, hh16, ww16, 3 * ch), dev)
    c32, lane8_32, s32 = _czrq_args("czrq32", czrq32, (b, hh32, ww32, 3 * ch), dev)
    if lane8 != lane8_32:
        raise TypeError("gru1632 kernel: czrq16 and czrq32 must both be bf16 or both int8")
    for name, t, shape in (("h16", h16, (b, hh16, ww16, ch)), ("h32", h32, (b, hh32, ww32, ch)),
                           ("x0p", x0p, (b, hh16, ww16, cx0)), ("x1p", x1p, (b, hh32, ww32, ch)),
                           ("w16.w_gate_k", w16.w_gate_k, (9, 3 * ch, 2 * ch + cx0)),
                           ("w16.w_q_k", w16.w_q_k, (9, ch, ch)),
                           ("w32.w_gate_k", w32.w_gate_k, (9, 3 * ch, 2 * ch)),
                           ("w32.w_q_k", w32.w_q_k, (9, ch, ch))):
        _check_nhwc(name, t, shape, dt, dev)
    yi, yw = lerp_taps(hh32, hh16, dt, dev)
    xi, xw = lerp_taps(ww32, ww16, dt, dev)
    z16, rh16, up, h16_out = (torch.empty_like(h16) for _ in range(4))
    z32, rh32, h32_out = (torch.empty_like(h32) for _ in range(3))
    aqx16 = torch.empty(h16.shape, dtype=torch.float32, device=dev)
    aqx32 = torch.empty(h32.shape, dtype=torch.float32, device=dev)
    bar = torch.empty(kernels.entry("gru1632_counters")(b, hh16, hh32), dtype=torch.int32,
                      device=dev)
    fn = kernels.entry("gru1632")
    kernels.check("gru1632", fn(
        h16.data_ptr(), h32.data_ptr(), c16, c32, lane8, s16, s32, x0p.data_ptr(), cx0,
        x1p.data_ptr(), b, hh16, ww16, hh32, ww32, ch,
        w16.w_gate_k.data_ptr(), w16.w_q_k.data_ptr(), w32.w_gate_k.data_ptr(),
        w32.w_q_k.data_ptr(), yi.data_ptr(), yw.data_ptr(), xi.data_ptr(), xw.data_ptr(),
        z16.data_ptr(), rh16.data_ptr(), aqx16.data_ptr(), z32.data_ptr(),
        rh32.data_ptr(), aqx32.data_ptr(), up.data_ptr(), h16_out.data_ptr(),
        h32_out.data_ptr(), bar.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    _count("gru1632", lane8)
    return h16_out, h32_out
