"""The refinement loop's kernels: the ConvGRU step (optionally with the
FlowHead) and the motion encoder.

Counterpart of the JAX package's ``ops/pallas_stream.py``. Each kernel has
a wrapper that launches ``csrc/conv_gru.cu`` or ``csrc/motion.cu`` on CUDA
tensors, and a plain torch version with the same signature and the same
rounding points that the wrapper runs on CPU tensors. There is no other
route between them: a CUDA tensor the kernel does not take raises.

The kernels round where the Pallas kernels do, which is not where the plain
torch modules of ``models/update.py`` round:

- GRU: the gate biases are folded into the context once per frame and
  rounded to bf16 (:func:`prepare_gru_context`); z, r, r*h and q round to
  bf16 at their nonlinearities; ``h' = (1 - z) * h + z * q`` runs in bf16.
- FlowHead: ``f1 = bf16(relu(conv1(h') + b1))``; the x delta is
  ``conv2(f1)[..., 0]`` in fp32 without ``conv2.b[0]``, which the caller adds.
- Motion: ``c1``, ``f1``, ``[c2|f2]`` and the fused output round to bf16
  after their relus; convf1's flow-y weights are dropped (flow y is 0).

Weights are converted once per frame into the kernels' layout: tap-major
``(9, Cin, Cout)`` matrices in the compute dtype, output columns zero-padded
to a multiple of 64 (:func:`gru_weights`, :func:`head_weights`,
:func:`motion_weights`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch import kernels

_COL = 64  # csrc/conv3x3.cuh pad64: output-column multiple of weight matrices
_HEAD2_COLS = 16  # columns of the FlowHead conv2 matrix (one used)


def _pad64(n: int) -> int:
    return -(-n // _COL) * _COL


def _taps(w: torch.Tensor) -> torch.Tensor:
    """OIHW 3x3 weight -> (9, Cin, Cout)."""
    cout, cin = w.shape[:2]
    return w.permute(2, 3, 1, 0).reshape(9, cin, cout)


def _pad_cols(w: torch.Tensor, cols: int) -> torch.Tensor:
    return F.pad(w, (0, cols - w.shape[-1])).contiguous()


def _conv9(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """fp32 3x3 conv of NHWC ``x`` with a (9, Cin, Cout) tap matrix, zero
    padding 1: the kernels' fp32 accumulator."""
    cin, cout = w9.shape[1:]
    w = w9.float().reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w, None, 1, 1)
    return out.permute(0, 2, 3, 1)


class GruWeights(NamedTuple):
    w_gate: torch.Tensor  # (9, ch + cx, pad64(3ch)): [wz | wr | wq] over [h; x]
    w_q: torch.Tensor     # (9, ch, pad64(ch)): wq over h (applied to r*h)
    ch: int
    level: str            # the GRU's name, keys its launch count


class HeadWeights(NamedTuple):
    w1: torch.Tensor  # (9, ch, pad64(nh))
    b1: torch.Tensor  # (nh,) fp32
    w2: torch.Tensor  # (9, nh, 16): conv2's x output in column 0
    nh: int


class MotionWeights(NamedTuple):
    wc1: torch.Tensor  # (ccorr, n1): convc1, 1x1
    wf1: torch.Tensor  # (49, nf): convf1 over flow x, taps row-major
    b1: torch.Tensor   # (n1 + nf,) fp32
    w2: torch.Tensor   # (9, ns, pad64(ns)): block-diagonal [convc2, convf2]
    b2: torch.Tensor   # (ns,) fp32
    wf: torch.Tensor   # (9, ns, pad64(cf + 2)): the fusion conv
    bf: torch.Tensor   # (cf,) fp32
    n1: int
    nf: int
    cf: int


def gru_weights(gru, dtype: torch.dtype, level: str = "gru") -> GruWeights:
    """Kernel-layout weights of a ConvGRU module (convz/convr/convq over
    ``[h; x]``). The kernel's launches with them count under
    ``conv_gru:<level>``."""
    ch = gru.convz.weight.shape[0]
    wz, wr, wq = (_taps(c.weight) for c in (gru.convz, gru.convr, gru.convq))
    w_gate = torch.cat([wz, wr, wq], dim=-1).to(dtype)
    return GruWeights(_pad_cols(w_gate, _pad64(3 * ch)),
                      _pad_cols(wq[:, :ch].to(dtype), _pad64(ch)), ch, level)


def head_weights(head, dtype: torch.dtype) -> HeadWeights:
    """Kernel-layout weights of a FlowHead (conv1 3x3 + relu, conv2 3x3)."""
    nh = head.conv1.weight.shape[0]
    w1 = _pad_cols(_taps(head.conv1.weight).to(dtype), _pad64(nh))
    w2 = _pad_cols(_taps(head.conv2.weight)[..., :1].to(dtype), _HEAD2_COLS)
    return HeadWeights(w1, head.conv1.bias.float().contiguous(), w2, nh)


def motion_weights(enc, dtype: torch.dtype) -> MotionWeights:
    """Kernel-layout weights of a BasicMotionEncoder."""
    n1 = enc.convc1.weight.shape[0]
    nf = enc.convf1.weight.shape[0]
    ns = n1 + nf
    cf = enc.conv.weight.shape[0]
    wc1 = enc.convc1.weight[:, :, 0, 0].t().to(dtype).contiguous()
    wf1 = enc.convf1.weight[:, 0].reshape(nf, 49).t().to(dtype).contiguous()
    b1 = torch.cat([enc.convc1.bias, enc.convf1.bias]).float()
    w2 = torch.zeros(9, ns, _pad64(ns), dtype=dtype, device=wc1.device)
    w2[:, :n1, :n1] = _taps(enc.convc2.weight).to(dtype)
    w2[:, n1:, n1:ns] = _taps(enc.convf2.weight).to(dtype)
    b2 = torch.cat([enc.convc2.bias, enc.convf2.bias]).float()
    wf = _pad_cols(_taps(enc.conv.weight).to(dtype), _pad64(cf + 2))
    return MotionWeights(wc1, wf1, b1, w2, b2, wf, enc.conv.bias.float().contiguous(),
                         n1, nf, cf)


def prepare_gru_context(gru, context: Sequence[torch.Tensor],
                        dtype: torch.dtype) -> torch.Tensor:
    """Fold the gate conv biases into the (cz, cr, cq) context and round
    once: ``czrq = dtype(concat(context) + [bz | br | bq])``. Built once per
    frame, outside the loop."""
    bias = torch.cat([gru.convz.bias, gru.convr.bias, gru.convq.bias]).float()
    return (torch.cat(list(context), dim=-1).float() + bias).to(dtype).contiguous()


# -- ConvGRU (+ FlowHead): kernel 2 ------------------------------------------


def conv_gru_plain(w: GruWeights, h: torch.Tensor, czrq: torch.Tensor,
                   *x_list: torch.Tensor, head: Optional[HeadWeights] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version of :func:`fused_conv_gru`."""
    ch, dt = w.ch, h.dtype
    x = torch.cat(x_list, dim=-1)
    ctx = czrq.float()
    zr = _conv9(torch.cat([h, x], dim=-1), w.w_gate[..., :2 * ch]) + ctx[..., :2 * ch]
    z = torch.sigmoid(zr[..., :ch]).to(dt)
    r = torch.sigmoid(zr[..., ch:]).to(dt)
    rh = r * h
    aqx = _conv9(x, w.w_gate[:, ch:, 2 * ch:3 * ch]) + ctx[..., 2 * ch:]
    q = torch.tanh(_conv9(rh, w.w_q[..., :ch]) + aqx).to(dt)
    h_new = (1 - z) * h + z * q
    if head is None:
        return h_new, None
    f1 = torch.relu(_conv9(h_new, head.w1[..., :head.nh]) + head.b1).to(dt)
    return h_new, _conv9(f1, head.w2[..., :1])


def _check_nhwc(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def fused_conv_gru(w: GruWeights, h: torch.Tensor, czrq: torch.Tensor,
                   *x_list: torch.Tensor, head: Optional[HeadWeights] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One ConvGRU step on NHWC tensors; with ``head``, the FlowHead's x
    delta too (the JAX package's ``fused_conv_gru`` and ``fused_gru_head``).
    Returns ``(h', dx)`` with ``dx`` (B, H, W, 1) fp32 without
    ``conv2.b[0]``, or ``None`` without the head.

    h: (B, H, W, ch); czrq: (B, H, W, 3ch) from :func:`prepare_gru_context`;
    x_list: one to three (B, H, W, c_i) inputs, never concatenated.
    """
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
    _check_nhwc("czrq", czrq, (b, hh, ww, 3 * ch), dt, dev)
    for i, (x, c) in enumerate(zip(x_list, cxs)):
        _check_nhwc(f"x_list[{i}]", x, (b, hh, ww, c), dt, dev)
    _check_nhwc("w_gate", w.w_gate, (9, ch + sum(cxs), _pad64(3 * ch)), dt, dev)
    _check_nhwc("w_q", w.w_q, (9, ch, _pad64(ch)), dt, dev)
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
        _check_nhwc("head.w1", head.w1, (9, ch, _pad64(nh)), dt, dev)
        _check_nhwc("head.b1", head.b1, (nh,), torch.float32, dev)
        _check_nhwc("head.w2", head.w2, (9, nh, _HEAD2_COLS), dt, dev)
        f1 = torch.empty((b, hh, ww, nh), dtype=dt, device=dev)
        dx = torch.empty((b, hh, ww, 1), dtype=torch.float32, device=dev)
        w1, b1, w2 = head.w1.data_ptr(), head.b1.data_ptr(), head.w2.data_ptr()
    fn = kernels.entry("conv_gru")
    kernels.check("conv_gru", fn(
        h.data_ptr(), czrq.data_ptr(), parts[0][0], parts[0][1], parts[1][0],
        parts[1][1], parts[2][0], parts[2][1], b, hh, ww, ch, w.w_gate.data_ptr(),
        w.w_q.data_ptr(), z.data_ptr(), rh.data_ptr(), aqx.data_ptr(),
        h_out.data_ptr(), w1, b1, w2, nh, None if f1 is None else f1.data_ptr(),
        None if dx is None else dx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    kernels.launches[f"conv_gru:{w.level}"] += 1
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
    ns = w.n1 + w.nf
    s2 = torch.relu(_conv9(s1, w.w2[..., :ns]) + w.b2).to(dt)
    out = torch.relu(_conv9(s2, w.wf[..., :w.cf]) + w.bf).to(dt)
    return torch.cat([out, flow], dim=-1)


def fused_motion(w: MotionWeights, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """Motion features (B, H, W, cf + 2): the fused 126 channels, then the
    raw 2-channel flow. flow: (B, H, W, 2) with y == 0; corr: (B, H, W, L(2r+1))."""
    if corr.device.type == "cpu":
        return motion_plain(w, flow, corr)
    b, hh, ww, ccorr = corr.shape
    dev, dt = corr.device, torch.bfloat16
    if w.n1 % _COL or w.nf % _COL:
        raise ValueError(f"motion kernel branch widths must be multiples of {_COL}, "
                         f"got {w.n1}, {w.nf}")
    ns = w.n1 + w.nf
    _check_nhwc("corr", corr, (b, hh, ww, ccorr), dt, dev)
    _check_nhwc("flow", flow, (b, hh, ww, 2), dt, dev)
    _check_nhwc("wc1", w.wc1, (ccorr, w.n1), dt, dev)
    _check_nhwc("wf1", w.wf1, (49, w.nf), dt, dev)
    _check_nhwc("b1", w.b1, (ns,), torch.float32, dev)
    _check_nhwc("w2", w.w2, (9, ns, _pad64(ns)), dt, dev)
    _check_nhwc("b2", w.b2, (ns,), torch.float32, dev)
    _check_nhwc("wf", w.wf, (9, ns, _pad64(w.cf + 2)), dt, dev)
    _check_nhwc("bf", w.bf, (w.cf,), torch.float32, dev)
    s1 = torch.empty((b, hh, ww, ns), dtype=dt, device=dev)
    s2 = torch.empty_like(s1)
    out = torch.empty((b, hh, ww, w.cf + 2), dtype=dt, device=dev)
    fn = kernels.entry("motion")
    kernels.check("motion", fn(
        corr.data_ptr(), ccorr, flow.data_ptr(), b, hh, ww, w.wc1.data_ptr(),
        w.wf1.data_ptr(), w.b1.data_ptr(), w.n1, w.nf, w.w2.data_ptr(),
        w.b2.data_ptr(), w.wf.data_ptr(), w.bf.data_ptr(), w.cf, s1.data_ptr(),
        s2.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    kernels.launches["motion"] += 1
    return out
