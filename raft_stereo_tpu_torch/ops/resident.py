"""The resident iteration: correlation lookup, motion encoder, gru08 and
FlowHead in one kernel launch.

Counterpart of the JAX package's ``ops/pallas_resident.py``.
:func:`fused_iter` launches ``csrc/resident.cu`` on CUDA tensors and
:func:`fused_iter_plain`, the serial composition in plain torch, on CPU
tensors; a CUDA tensor the kernel does not take raises. The kernel is bit
for bit the serial chain of kernels it replaces (``lookup`` →
``fused_motion`` → ``fused_conv_gru`` with the head), because it runs the
same stage code (``csrc/stages.cuh``, ``corr_taps.cuh``,
``motion_stage1.cuh``).

Inference only, for the default zero-initialised flow: like the motion
kernel it drops convf1's flow-y weights, so a caller-supplied flow_init
keeps the serial path. Under ``RAFT_CORR_PACK8`` the kernel gathers from the
operands' int8 levels, with the lookup's dequantization (the JAX package's
``packed8`` ``_corr_rows``). Under ``RAFT_LANE_PACK8`` czrq is an int8 lane
container and the gate stage adds ``q * scale`` (the JAX package's
``_resident_lane8_kernel``); a container that arrives while the switch is
off raises, as in the JAX package, so stale quantization never serves. A
launch counts under ``fused_iter`` and, in an int8 mode, once more as the
variant ``fused_iter:pack8``, ``fused_iter:lane8`` or
``fused_iter:pack8+lane8``.

Test mode only, as in the JAX package (which engages it only in its
test-mode scan): it has no backward, and reached under grad with an input
that requires grad it raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_stereo_tpu_torch import kernels
from raft_stereo_tpu_torch.config import lane_pack8_on
from raft_stereo_tpu_torch.corr.reg_cuda import CorrOperands, Lane8, kernel_levels, lookup_plain
from raft_stereo_tpu_torch.ops.grad import refuse_grad
from raft_stereo_tpu_torch.ops.stream import (
    Czrq, GruWeights, HeadWeights, MotionWeights, _check_nhwc, _czrq_args,
    conv_gru_plain, motion_plain)

_MAX_X2 = 2  # gru08 x parts after the motion features (csrc/loop_conv_sm90.cuh kParts - 2)


def loop_plan() -> dict:
    """The loop engine's block on this card (``csrc/loop_conv_sm90.cuh``, the
    resident kernel and the serial motion and gru08 + head launches): its
    dynamic shared memory, its threads and the resident kernel's blocks an
    SM. Builds the kernel if needed; needs the card."""
    plan = (ctypes.c_int * 3)()
    kernels.check("resident_plan", kernels.entry("resident_plan")(plan))
    return {"dynamic_smem_bytes": plan[0], "threads": plan[1], "blocks_per_sm": plan[2]}


def fused_iter_plain(motion_w: MotionWeights, gru_w: GruWeights, head_w: HeadWeights,
                     corr_ops: CorrOperands, h: torch.Tensor, czrq: Czrq,
                     coords_x: torch.Tensor, flow: torch.Tensor, *x2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`fused_iter`: lookup, motion encoder,
    gru08 with the head."""
    corr = lookup_plain(corr_ops, coords_x)
    motion = motion_plain(motion_w, flow, corr)
    return conv_gru_plain(gru_w, h, czrq, motion, *x2, head=head_w)


def fused_iter(motion_w: MotionWeights, gru_w: GruWeights, head_w: HeadWeights,
               corr_ops: CorrOperands, h: torch.Tensor, czrq: Czrq,
               coords_x: torch.Tensor, flow: torch.Tensor, *x2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One iteration at the finest scale (the JAX package's
    ``fused_iter_fwd_impl``). Returns ``(h', dx)``: the new gru08 state and
    the FlowHead's x delta, (B, H, W, 1) fp32 without ``conv2.b[0]`` (the
    ``fused_gru_head`` contract).

    corr_ops: the frame's pyramid (:func:`~raft_stereo_tpu_torch.corr.
    reg_cuda.build_corr_operands`); h: (B, H, W, ch); czrq: from
    ``prepare_gru_context_any`` (bf16, or an int8 container under
    ``RAFT_LANE_PACK8``, which must still be on); coords_x: (B, H, W) fp32 x
    positions; flow: (B, H, W, 2) with y == 0; x2: gru08's x parts after the
    motion features (the upsampled gru16 state).
    """
    if isinstance(czrq, Lane8) and not lane_pack8_on():
        raise RuntimeError(
            "fused_iter: an int8 czrq container arrived with RAFT_LANE_PACK8 off; the "
            "switch must stay on for the lifetime of a packed state")
    refuse_grad("fused_iter", list(motion_w[:7]), gru_w[:2], list(head_w[:3]), corr_ops.levels,
                h, czrq, coords_x, flow, x2)
    if h.device.type == "cpu":
        return fused_iter_plain(motion_w, gru_w, head_w, corr_ops, h, czrq, coords_x, flow,
                                *x2)
    b, hh, ww, ch = h.shape
    dev, dt = h.device, torch.bfloat16
    nlev = len(corr_ops.levels)
    if (corr_ops.b, corr_ops.h, corr_ops.w1) != (b, hh, ww):
        raise ValueError(f"corr operands of {(corr_ops.b, corr_ops.h, corr_ops.w1)}, "
                         f"state of {(b, hh, ww)}")
    if corr_ops.levels[0].dtype != dt:
        raise TypeError(f"resident kernel takes a bf16 pyramid, got {corr_ops.levels[0].dtype}")
    rows, widths, mode, scales = kernel_levels(corr_ops, dev)
    if coords_x.dtype != torch.float32 or tuple(coords_x.shape) != (b, hh, ww):
        raise ValueError(f"coords_x must be fp32 of shape {(b, hh, ww)}, "
                         f"got {coords_x.dtype} {tuple(coords_x.shape)}")
    coords = coords_x.contiguous()
    if len(x2) > _MAX_X2:
        raise ValueError(f"the resident kernel takes 0..{_MAX_X2} x2 parts, got {len(x2)}")
    m, cm = motion_w, motion_w.cf + 2
    ccorr = nlev * (2 * corr_ops.radius + 1)
    cxs = [x.shape[-1] for x in x2]
    if ch != gru_w.ch or any(c % 32 for c in [ch, cm, *cxs]):
        raise ValueError(f"resident kernel channels must be multiples of 32: ch={ch}, "
                         f"motion {cm}, x2 {cxs}")
    if m.n1 % 64 or m.nf % 64 or head_w.nh % 32:
        raise ValueError(f"resident kernel widths: motion branches {m.n1}, {m.nf} "
                         f"(multiples of 64), head {head_w.nh} (of 32)")
    ns = m.n1 + m.nf
    czrq_ptr, lane8, scale_ptr = _czrq_args("czrq", czrq, (b, hh, ww, 3 * ch), dev)
    for name, t, shape, tdt in (
            ("h", h, (b, hh, ww, ch), dt), ("flow", flow, (b, hh, ww, 2), dt),
            ("wc1", m.wc1, (ccorr, m.n1), dt), ("wf1", m.wf1, (49, m.nf), dt),
            ("b1", m.b1, (ns,), torch.float32), ("w2_k", m.w2_k, (9, ns, ns), dt),
            ("b2", m.b2, (ns,), torch.float32), ("wf_k", m.wf_k, (9, m.cf, ns), dt),
            ("bf", m.bf, (m.cf,), torch.float32),
            ("w_gate_k", gru_w.w_gate_k, (9, 3 * ch, ch + cm + sum(cxs)), dt),
            ("w_q_k", gru_w.w_q_k, (9, ch, ch), dt),
            ("head.w1_k", head_w.w1_k, (9, head_w.nh, ch), dt),
            ("head.b1", head_w.b1, (head_w.nh,), torch.float32),
            ("head.w2_k", head_w.w2_k, (9, 1, head_w.nh), dt)):
        _check_nhwc(name, t, shape, tdt, dev)
    for i, (x, c) in enumerate(zip(x2, cxs)):
        _check_nhwc(f"x2[{i}]", x, (b, hh, ww, c), dt, dev)
    parts = [(x.data_ptr(), c) for x, c in zip(x2, cxs)] + [(None, 0)] * (_MAX_X2 - len(x2))
    s1 = torch.empty((b, hh, ww, ns), dtype=dt, device=dev)
    s2 = torch.empty_like(s1)
    mot = torch.empty((b, hh, ww, cm), dtype=dt, device=dev)
    z, rh, h_out = (torch.empty_like(h) for _ in range(3))
    aqx = torch.empty(h.shape, dtype=torch.float32, device=dev)
    f1 = torch.empty((b, hh, ww, head_w.nh), dtype=dt, device=dev)
    dx = torch.empty((b, hh, ww, 1), dtype=torch.float32, device=dev)
    bar = torch.empty(kernels.entry("resident_counters")(b, hh), dtype=torch.int32, device=dev)
    fn = kernels.entry("resident")
    kernels.check("resident", fn(
        coords.data_ptr(), rows, widths, nlev, corr_ops.radius, int(mode == 2), scales,
        flow.data_ptr(),
        h.data_ptr(), czrq_ptr, lane8, scale_ptr, parts[0][0], parts[0][1], parts[1][0],
        parts[1][1],
        b, hh, ww, ch, m.wc1.data_ptr(), m.wf1.data_ptr(), m.b1.data_ptr(), m.n1, m.nf,
        m.w2_k.data_ptr(), m.b2.data_ptr(), m.wf_k.data_ptr(), m.bf.data_ptr(), m.cf,
        gru_w.w_gate_k.data_ptr(), gru_w.w_q_k.data_ptr(), head_w.w1_k.data_ptr(),
        head_w.b1.data_ptr(), head_w.w2_k.data_ptr(), head_w.nh, s1.data_ptr(),
        s2.data_ptr(), mot.data_ptr(), z.data_ptr(), rh.data_ptr(), aqx.data_ptr(),
        f1.data_ptr(), h_out.data_ptr(), dx.data_ptr(), bar.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    modes = "+".join(m for m, on in (("pack8", corr_ops.pack8), ("lane8", lane8)) if on)
    kernels.count_launch("fused_iter", modes or None)
    return h_out, dx
