"""The fused encoders: the stem, the streamed 3x3 conv pass and the
point2/point3 exits, and the chains the encoders build from them.

Counterpart of the JAX package's ``ops/pallas_encoder.py``. Four kernels,
each with a wrapper that launches ``csrc/enc_stem.cu``, ``csrc/enc_pass.cu``
or ``csrc/enc_point.cu`` on CUDA tensors and a plain torch version with the
same signature and rounding points that the wrapper runs on CPU tensors.
There is no other route between them: a CUDA tensor the kernel does not take
raises.

One pass per convolution. Pass k reads conv k-1's raw output and applies the
norm and relu that follow conv k-1 while it loads it; under instance norm
(the feature net) with the per-channel statistics that pass k-1 took of its
own fp32 outputs, under frozen BatchNorm (the context net) with the norm
folded into conv k-1's weights, which leaves a relu. So no normalized, relu'd
or summed tensor is ever written. The rounding points are the Pallas
kernels', not those of the plain modules in ``models/layers.py``:

- a conv's output is ``dtype(acc + bias)``: fp32 accumulator, fp32 bias, one
  rounding (``ops/basic.py:conv2d`` rounds the accumulator, then adds a
  rounded bias);
- the transform of a raw output is ``dtype(relu((x - mean) * inv))`` in fp32
  under instance norm, ``relu(x)`` under folded BatchNorm;
- statistics are sums of the fp32 ``acc + bias``, before the rounding;
- ``mid2`` rounds the sum of two transformed maps to ``dtype``; ``point3``
  keeps the same sum in fp32 under instance norm.

Under ``RAFT_LANE_PACK8`` the raw1 pass (the zqr context convs) and the
point2 exit have a quantize-on-exit variant (``quant=True``; the JAX
package's ``_pass_q8_kernel`` and ``_point2_q8_kernel``): they return the
int8 container of their bf16 output (``corr/reg_cuda.py:quantize_feature8``,
bit for bit) instead of the map. The point2 kernel never writes the map;
the pass writes it once to a scratch map that the L2 cache holds at the
KITTI widths and frees it after the call (the TPU kernel wrote no map for
want of VMEM; here a map in L2 costs less than running the conv twice).

Maps are ``(1, H, W, C)``; a transformed input is a ``(raw, mean, inv)``
triple with ``mean``/``inv`` ``(C,)`` fp32, or ``None`` where no statistics
apply. Conv weights come in as OIHW fp32 (BatchNorm already folded) and are
cast to the map's dtype here; biases stay fp32. The plain versions take any
float dtype, so the CPU tests also run them in fp32. The chains take their
weights from :func:`module_weights`: folded and cast once per model, laid
out for the kernels once per device, rebuilt when a parameter or buffer
changes.

Training: the four chains (:func:`fused_stem_layer1`,
:func:`fused_in_stem_layer1`, :func:`stream_resblock`,
:func:`stream_head_conv`) are differentiable (``ops/grad.py``): the kernels
run forward, and the backward is autograd through the same chain of plain
versions recomputed from the input and the modules' parameters (BatchNorm
folded differentiably, the instance-norm statistics differentiated), the
JAX package's XLA oracles. In grad mode :func:`module_weights` builds the
folded weights afresh on every call instead of handing back the detached
cache. The single kernel entries and the q8 chains have no backward and
raise under grad.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch import kernels
from raft_stereo_tpu_torch.config import fused_encoders_on, lane_pack8_on, stream_tail_on
from raft_stereo_tpu_torch.corr.reg_cuda import Lane8, quantize_feature8
from raft_stereo_tpu_torch.ops.grad import recompute, refuse_grad
from raft_stereo_tpu_torch.ops.stream import _check_nhwc as _check

Stats = Optional[torch.Tensor]  # (2, C) fp32: sum, sum of squares
Normed = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]
ConvWB = Tuple[torch.Tensor, Optional[torch.Tensor]]  # OIHW fp32 weight, fp32 bias

_KINDS = {"raw1": 0, "mid1": 1, "mid2": 2}
# The stem kernel's weight layout (csrc/enc_stem.cu kK, kTapRow; the kernel's
# plan reports both, and the wrapper holds them to these): K runs dy-major,
# 22 a tap row dy (its 7 x 3 taps, then a zero), 154 padded to 160.
_STEM_K = 160
_STEM_TAP_ROW = 22


def fold_bn(conv, bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frozen BatchNorm ``bn`` folded into the conv before it, in fp32, from
    the modules' current parameters and buffers: ``(w, b)``, OIHW."""
    return _fold(conv.weight, conv.bias, bn.weight, bn.bias, bn)


def _fold(w, b, scale, shift, bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fold_bn` from the given conv and BatchNorm parameters and
    ``bn``'s running statistics (buffers, never trained)."""
    k = scale.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    b0 = 0.0 if b is None else b.float()
    return w.float() * k[:, None, None, None], (b0 - bn.running_mean.float()) * k + shift.float()


def _conv_wb(conv) -> ConvWB:
    return conv.weight.float(), None if conv.bias is None else conv.bias.float()


def _leaves(pairs) -> list:
    """The trainable tensors of (conv, bn-or-None) pairs, four a pair."""
    out = []
    for conv, bn in pairs:
        out += [conv.weight, conv.bias, None if bn is None else bn.weight,
                None if bn is None else bn.bias]
    return out


def _weights_from(pairs, lv) -> List["ConvWeights"]:
    """ConvWeights of (conv, bn) pairs from their :func:`_leaves`, folded
    differentiably."""
    out = []
    for j, (_, bn) in enumerate(pairs):
        w, b, scale, shift = lv[4 * j:4 * j + 4]
        if bn is None:
            out.append(ConvWeights(w.float(), None if b is None else b.float()))
        else:
            out.append(ConvWeights(*_fold(w, b, scale, shift, bn)))
    return out


class ConvWeights:
    """A conv's weight (OIHW fp32, BatchNorm folded where it applies) and
    fp32 bias, with the kernels' device layouts of them, each made at its
    first use and kept (``layout``)."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor]):
        self.w, self.b = w, b
        self._layouts = {}

    def layout(self, kernel: str, device, make):
        """``make(w, b, device)``, made once per kernel and device."""
        key = (kernel, device)
        if key not in self._layouts:
            self._layouts[key] = make(self.w, self.b, device)
        return self._layouts[key]


def _weights(w, bias) -> ConvWeights:
    return w if isinstance(w, ConvWeights) else ConvWeights(w, bias)


def _tensor_key(t: Optional[torch.Tensor]):
    """What identifies a tensor's current values: the object, its storage
    and its version counter (bumped by every in-place change, which
    ``load_state_dict``'s copies are)."""
    if t is None:
        return None
    return id(t), t.data_ptr(), t._version, t.device, t.dtype


def module_weights(conv, bn=None) -> ConvWeights:
    """``conv``'s weights for the chains, BatchNorm ``bn`` folded into them
    where given, kept on the module and rebuilt when one of the tensors
    they come from changes (a new parameter or buffer, an in-place update,
    ``load_state_dict``, a move to another device). In grad mode, with a
    parameter that requires grad, they are built afresh and differentiably
    on every call, and not kept."""
    tensors = [conv.weight, conv.bias]
    if bn is not None:
        tensors += [bn.weight, bn.bias, bn.running_mean, bn.running_var]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return ConvWeights(*(fold_bn(conv, bn) if bn is not None else _conv_wb(conv)))
    key = tuple(_tensor_key(t) for t in tensors)
    cached = conv.__dict__.get("_rst_weights")
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        cw = ConvWeights(*(fold_bn(conv, bn) if bn is not None else _conv_wb(conv)))
    conv.__dict__["_rst_weights"] = (key, cw)
    return cw


def stats_to_mv(stats: torch.Tensor, n: int, eps: float = 1e-5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(2, C)`` sums over ``n`` pixels -> per-channel mean and
    ``rsqrt(var + eps)``, the one-pass biased variance clamped at 0."""
    mean = stats[0] / n
    var = torch.clamp(stats[1] / n - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


# -- plain versions -----------------------------------------------------------


def _normed(raw: torch.Tensor, m: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return torch.relu((raw.float() - m) * inv).to(raw.dtype)


def _conv_out(v: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
              padding: int, stats: bool) -> Tuple[torch.Tensor, Stats]:
    """fp32 conv of ``v`` with ``w`` rounded to ``v``'s dtype, plus the fp32
    bias; rounded once. The statistics are fp64 sums of the fp32 outputs."""
    out = F.conv2d(v.float().permute(0, 3, 1, 2), w.to(v.dtype).float(),
                   None if bias is None else bias.float(), 1, padding).permute(0, 2, 3, 1)
    st = None
    if stats:
        o = out.double()
        st = torch.stack([o.sum(dim=(0, 1, 2)), o.square().sum(dim=(0, 1, 2))]).float()
    return out.to(v.dtype).contiguous(), st


def stem_plain(x: torch.Tensor, w, bias: Optional[torch.Tensor], *,
               stats: bool) -> Tuple[torch.Tensor, Stats]:
    """Plain torch version of :func:`stem`."""
    cw = _weights(w, bias)
    return _conv_out(x, cw.w, cw.b, 3, stats)


def _pass_input(kind: str, inputs: Sequence[Normed], stats: bool) -> torch.Tensor:
    if kind == "raw1":
        return inputs[0][0]
    if kind == "mid1":
        raw, m, inv = inputs[0]
        return _normed(raw, m, inv) if stats else torch.relu(raw)
    (a, ma, va), (b, mb, vb) = inputs
    if stats:
        return torch.relu(_normed(a, ma, va).float() + _normed(b, mb, vb)).to(a.dtype)
    return torch.relu(torch.relu(a) + torch.relu(b))


def conv_pass_plain(kind: str, inputs: Sequence[Normed], w,
                    bias: Optional[torch.Tensor], *, stats: bool, quant: bool = False
                    ) -> Tuple[torch.Tensor | Lane8, Stats]:
    """Plain torch version of :func:`conv_pass`."""
    _check_quant(kind, stats, quant)
    cw = _weights(w, bias)
    out, st = _conv_out(_pass_input(kind, inputs, stats), cw.w, cw.b, 1, stats)
    return (quantize_feature8(out) if quant else out), st


def point3_plain(s: Normed, y2: Normed, y4: Normed, *, norm: bool) -> torch.Tensor:
    """Plain torch version of :func:`point3`."""
    if norm:
        o1 = torch.relu(_normed(*s).float() + _normed(*y2))
        return torch.relu(o1 + _normed(*y4)).to(s[0].dtype)
    o1 = torch.relu(torch.relu(s[0]) + torch.relu(y2[0]))
    return torch.relu(o1 + torch.relu(y4[0]))


def point2_plain(x: torch.Tensor, y: Normed, *, norm: bool,
                 quant: bool = False) -> torch.Tensor | Lane8:
    """Plain torch version of :func:`point2`."""
    t = _normed(*y) if norm else torch.relu(y[0].float())
    out = torch.relu(x.float() + t).to(x.dtype)
    return quantize_feature8(out) if quant else out


# -- wrappers -------------------------------------------------------------------


def _check_quant(kind: str, stats: bool, quant: bool) -> None:
    if quant and (kind != "raw1" or stats):
        raise ValueError("the quantize-on-exit pass is a raw1 pass without statistics")


def _ptrs(*tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _q8_outputs(shape, device):
    """int8 q and its fp32 scale, a quantize-on-exit launch's outputs."""
    return (torch.empty(shape, dtype=torch.int8, device=device),
            torch.empty(1, dtype=torch.float32, device=device))


# The point2 q8 launch's six scratch words (its maximum, its barrier's and
# its work queue's counts), one set a (device, stream): two launches that
# run at once must not share them. Zero when made; each launch leaves them
# zero.
_point2_q8_words: Dict[Tuple[int, int], torch.Tensor] = {}


def _q8_words(device, stream) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    words = _point2_q8_words.get(key)
    if words is None:
        words = _point2_q8_words[key] = torch.zeros(6, dtype=torch.int32, device=device)
    return words


def _check_map(name: str, t: torch.Tensor, device) -> Tuple[int, int, int]:
    if t.ndim != 4 or t.shape[0] != 1 or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (1, H, W, C) map, got {tuple(t.shape)}")
    _check(name, t, t.shape, torch.bfloat16, device)
    return tuple(t.shape[1:])


def _mv_ptrs(name: str, triple: Normed, c: int, device, norm: bool):
    """Device pointers of a triple's mean and inv, checked; (None, None)
    where the transform reads none."""
    if not norm:
        return None, None
    for part, t in (("mean", triple[1]), ("inv", triple[2])):
        if t is None:
            raise ValueError(f"{name} needs its {part} under instance norm")
        _check(f"{name} {part}", t, (c,), torch.float32, device)
    return triple[1].data_ptr(), triple[2].data_ptr()


def _norm_name(instance: bool) -> str:
    """The variant's name in the launch counts (``kernels.variants``)."""
    return "instance" if instance else "bn"


def _bias_f32(bias: Optional[torch.Tensor], cout: int, device) -> torch.Tensor:
    if bias is None:
        return torch.zeros(cout, dtype=torch.float32, device=device)
    return bias.float().contiguous()


def _stem_layout(w: torch.Tensor, bias, dev):
    """The stem kernel's weights, [64][160] bf16: output channel n's row holds
    tap (dy, dx, ci) at ``dy * 22 + dx * 3 + ci`` and zeros elsewhere (so a
    pair of K values is two consecutive values of one image row), K-major as
    the kernel's wgmma reads B; and its fp32 bias."""
    wk = torch.zeros((64, 7, _STEM_TAP_ROW), dtype=torch.bfloat16, device=dev)
    wk[:, :, :21] = w.permute(0, 2, 3, 1).reshape(64, 7, 21)
    wk = F.pad(wk.reshape(64, 7 * _STEM_TAP_ROW), (0, _STEM_K - 7 * _STEM_TAP_ROW))
    return wk.contiguous(), _bias_f32(bias, 64, dev)


def stem_plan(h: int, w: int) -> Tuple[int, int, int]:
    """The stem kernel's plan for an ``h x w`` image, from the kernel: the
    rows of its partial statistics (one a block of its constant grid), and
    the K of its weight layout and of one tap row."""
    plan = (ctypes.c_int * 3)()
    kernels.check("enc_stem_plan", kernels.entry("enc_stem_plan")(h, w, plan))
    return plan[0], plan[1], plan[2]


def stem(x: torch.Tensor, w, bias: Optional[torch.Tensor], *,
         stats: bool) -> Tuple[torch.Tensor, Stats]:
    """The 7x7 stride-1 pad-3 stem conv of a ``(1, H, W, 3)`` image into 64
    channels (the JAX package's ``_run_stem``): ``(out, statistics)``, the
    statistics ``None`` without ``stats``. w: (64, 3, 7, 7), or the
    :class:`ConvWeights` of the conv (which then carry the bias)."""
    cw = _weights(w, bias)
    refuse_grad("enc_stem", x, cw.w, cw.b)
    if x.device.type == "cpu":
        return stem_plain(x, w, bias, stats=stats)
    dev = x.device
    hh, ww, cin = _check_map("x", x, dev)
    if cin != 3 or tuple(cw.w.shape) != (64, 3, 7, 7):
        raise ValueError(f"the stem kernel takes 3 -> 64 channels, 7x7: x {tuple(x.shape)}, "
                         f"w {tuple(cw.w.shape)}")
    wk, b = cw.layout("enc_stem", dev, _stem_layout)
    _check("bias", b, (64,), torch.float32, dev)
    rows, k, tap_row = stem_plan(hh, ww)
    if (k, tap_row) != (_STEM_K, _STEM_TAP_ROW):
        raise RuntimeError(f"the stem kernel's weight layout is K {k}, {tap_row} a tap row; "
                           f"_stem_layout builds {_STEM_K}, {_STEM_TAP_ROW}")
    out = torch.empty((1, hh, ww, 64), dtype=torch.bfloat16, device=dev)
    partial = st = None
    if stats:
        partial = torch.empty((rows, 2, 64), dtype=torch.float32, device=dev)
        st = torch.empty((2, 64), dtype=torch.float32, device=dev)
    fn = kernels.entry("enc_stem")
    kernels.check("enc_stem", fn(
        x.data_ptr(), wk.data_ptr(), b.data_ptr(), hh, ww, out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if st is None else st.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    kernels.count_launch("enc_stem", _norm_name(stats))
    return out, st


def _pass_layout(w: torch.Tensor, bias, dev):
    """The pass kernel's weights, [9][cout][cin] bf16 (tap-major, input
    channels contiguous: the K-major tiles its TMA loads), and its fp32
    bias."""
    cout, cin = w.shape[:2]
    wk = w.permute(2, 3, 0, 1).reshape(9, cout, cin).to(device=dev, dtype=torch.bfloat16)
    return wk.contiguous(), _bias_f32(bias, cout, dev)


def pass_plan(kind: str, h: int, w: int, cin: int, cout: int) -> Tuple[int, int, int, int]:
    """The pass kernel's launch plan for a ``kind`` pass over an ``h x w x
    cin`` map into ``cout`` channels, from the kernel: the rows of its
    partial statistics (one per output patch, then the fp64 reduction's
    scratch), the output columns a block computes, its dynamic shared
    memory in bytes and the blocks an SM holds."""
    plan = (ctypes.c_int * 4)()
    kernels.check("enc_pass_plan", kernels.entry("enc_pass_plan")(_KINDS[kind], h, w, cin, cout,
                                                                  plan))
    return plan[0], plan[1], plan[2], plan[3]


def conv_pass(kind: str, inputs: Sequence[Normed], w,
              bias: Optional[torch.Tensor], *, stats: bool, quant: bool = False
              ) -> Tuple[torch.Tensor | Lane8, Stats]:
    """One 3x3 pad-1 conv pass with its input transform (the JAX package's
    ``_run_pass`` for the conv kinds): ``(out, statistics)``.

    kind ``raw1``: the input is an activation, no transform; ``mid1``: one
    transformed raw input; ``mid2``: ``relu`` of the sum of two. ``stats``
    means instance norm: the mid kinds normalize with the triples' mean and
    inv, and the pass returns the statistics of its own fp32 outputs;
    without it (BatchNorm folded into ``w`` and ``bias``) the transform is a
    relu and the statistics are ``None``. w: (Cout, Cin, 3, 3), or the
    :class:`ConvWeights` of the conv (which then carry the bias); the kernel
    takes Cin in multiples of 32 and Cout in multiples of 8. ``quant`` (raw1
    without statistics only): the output's int8 container in place of the
    map."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {sorted(_KINDS)}, got {kind!r}")
    if len(inputs) != (2 if kind == "mid2" else 1):
        raise ValueError(f"{kind} takes {2 if kind == 'mid2' else 1} input(s), got {len(inputs)}")
    a = inputs[0][0]
    cw = _weights(w, bias)
    refuse_grad("enc_pass" + ("/q8" if quant else ""), [t for tr in inputs for t in tr], cw.w,
                cw.b)
    if a.device.type == "cpu":
        return conv_pass_plain(kind, inputs, w, bias, stats=stats, quant=quant)
    _check_quant(kind, stats, quant)
    dev = a.device
    hh, ww, cin = _check_map("inputs[0]", a, dev)
    cout = cw.w.shape[0]
    if tuple(cw.w.shape) != (cout, cin, 3, 3) or cin % 32 or cout % 8:
        raise ValueError(f"the pass kernel takes a (Cout, {cin}, 3, 3) weight, input channels "
                         f"in multiples of 32 and output channels in multiples of 8, got w "
                         f"{tuple(cw.w.shape)}")
    norm = stats and kind != "raw1"
    ma, va = _mv_ptrs("inputs[0]", inputs[0], cin, dev, norm)
    b_ptr = mb = vb = None
    if kind == "mid2":
        _check("inputs[1]", inputs[1][0], a.shape, torch.bfloat16, dev)
        b_ptr = inputs[1][0].data_ptr()
        mb, vb = _mv_ptrs("inputs[1]", inputs[1], cin, dev, norm)
    wk, b = cw.layout("enc_pass", dev, _pass_layout)
    _check("bias", b, (cout,), torch.float32, dev)
    q = scale = amax = partial = st = None
    # Under quant, `out` is the bf16 scratch map the kernel quantizes from,
    # freed when this call returns.
    out = torch.empty((1, hh, ww, cout), dtype=torch.bfloat16, device=dev)
    if quant:
        q, scale = _q8_outputs((1, hh, ww, cout), dev)
        amax = torch.empty(1, dtype=torch.int32, device=dev)
    if stats:
        partial = torch.empty((pass_plan(kind, hh, ww, cin, cout)[0], 2, cout),
                              dtype=torch.float32, device=dev)
        st = torch.empty((2, cout), dtype=torch.float32, device=dev)
    fn = kernels.entry("enc_pass")
    kernels.check("enc_pass", fn(
        _KINDS[kind], int(norm), a.data_ptr(), ma, va, b_ptr, mb, vb, hh, ww, cin,
        wk.data_ptr(), b.data_ptr(), cout, *_ptrs(out, partial, st, q, scale, amax),
        torch.cuda.current_stream(dev).cuda_stream))
    kernels.count_launch("enc_pass", f"{kind}/{_norm_name(stats)}/{cin}{'/q8' if quant else ''}")
    if quant:
        del out  # the scratch map, once the stream is past its last reader
        return Lane8(q, scale), st
    return out, st


def _launch_point(kind: int, norm: bool, triples: Sequence[Normed], out_like: torch.Tensor,
                  quant: bool = False) -> torch.Tensor | Lane8:
    dev = out_like.device
    hh, ww, c = _check_map("inputs[0]", out_like, dev)
    if c % 8:
        raise ValueError(f"the point kernels take channels in multiples of 8, got {c}")
    args = []
    for i, t in enumerate(triples):
        _check(f"inputs[{i}]", t[0], out_like.shape, torch.bfloat16, dev)
        args += [t[0].data_ptr(), *_mv_ptrs(f"inputs[{i}]", t, c, dev, norm and t[1] is not None)]
    args += [None] * (9 - len(args))
    stream = torch.cuda.current_stream(dev)
    out = q = scale = words = None
    if quant:
        q, scale = _q8_outputs(out_like.shape, dev)
        words = _q8_words(dev, stream)
    else:
        out = torch.empty_like(out_like)
    fn = kernels.entry("enc_point")
    kernels.check("enc_point", fn(kind, int(norm), *args, hh * ww, c,
                                  *_ptrs(out, q, scale, words), stream.cuda_stream))
    return Lane8(q, scale) if quant else out


def point3(s: Normed, y2: Normed, y4: Normed, *, norm: bool) -> torch.Tensor:
    """layer1's exit (the JAX package's ``_point3_kernel``):
    ``o1 = relu(t(s) + t(y2))``, ``out = relu(o1 + t(y4))`` over three raw
    conv outputs. ``norm``: instance norm (the triples' mean and inv apply
    and ``o1`` stays fp32); else relus in the maps' dtype."""
    refuse_grad("enc_point3", s, y2, y4)
    if s[0].device.type == "cpu":
        return point3_plain(s, y2, y4, norm=norm)
    if norm and any(t[1] is None for t in (s, y2, y4)):
        raise ValueError("point3 needs every input's mean and inv under instance norm")
    out = _launch_point(3, norm, (s, y2, y4), s[0])
    kernels.count_launch("enc_point3", f"{_norm_name(norm)}/{s[0].shape[-1]}")
    return out


def point2(x: torch.Tensor, y: Normed, *, norm: bool,
           quant: bool = False) -> torch.Tensor | Lane8:
    """A residual block's exit (the JAX package's ``_point2_kernel``):
    ``relu(x + t(y))`` with ``x`` the block's input, an activation, and ``y``
    the raw conv2 output; the sum in fp32, one rounding. ``quant``: the
    output's int8 container in place of the map (``_point2_q8_kernel``)."""
    refuse_grad("enc_point2" + ("/q8" if quant else ""), x, y)
    if x.device.type == "cpu":
        return point2_plain(x, y, norm=norm, quant=quant)
    if norm and y[1] is None:
        raise ValueError("point2 needs y's mean and inv under instance norm")
    out = _launch_point(2, norm, ((x, None, None), y), x, quant)
    kernels.count_launch("enc_point2", f"{_norm_name(norm)}/{x.shape[-1]}{'/q8' if quant else ''}")
    return out


# -- chains ---------------------------------------------------------------------


def _ops(plain: bool) -> dict:
    """The single steps of a chain: the kernels' wrappers, or their plain
    versions, which the backward recomputes through (looked up at call
    time)."""
    if plain:
        return {"stem": stem_plain, "pass": conv_pass_plain, "point3": point3_plain,
                "point2": point2_plain}
    return {"stem": stem, "pass": conv_pass, "point3": point3, "point2": point2}


def _trunk_passes(x: torch.Tensor, convs: List[ConvWeights], instance: bool,
                  plain: bool = False) -> torch.Tensor:
    """Stem + layer1 over a ``(1, H, W, 3)`` image. convs: the stem's
    weights and layer1's four, BatchNorm folded for the frozen-BN trunk."""
    op = _ops(plain)
    n = x.shape[1] * x.shape[2]

    def mv(st):
        return stats_to_mv(st, n) if instance else (None, None)

    ws, w1, w2, w3, w4 = convs
    raw, st = op["stem"](x, ws, None, stats=instance)
    s = (raw, *mv(st))
    raw, st = op["pass"]("mid1", [s], w1, None, stats=instance)
    raw, st = op["pass"]("mid1", [(raw, *mv(st))], w2, None, stats=instance)
    y2 = (raw, *mv(st))
    raw, st = op["pass"]("mid2", [s, y2], w3, None, stats=instance)
    raw, st = op["pass"]("mid1", [(raw, *mv(st))], w4, None, stats=instance)
    return op["point3"](s, y2, (raw, *mv(st)), norm=instance)


def _layer1_convs(trunk):
    blk1, blk2 = trunk.layer1
    return [(trunk.conv1, trunk.norm1), (blk1.conv1, blk1.norm1), (blk1.conv2, blk1.norm2),
            (blk2.conv1, blk2.norm1), (blk2.conv2, blk2.norm2)]


def _chain(pairs, x: torch.Tensor, body):
    """``body(x, convs, plain)`` with the kernels forward, differentiable in
    ``x`` and the pairs' parameters through the plain versions."""
    return recompute(lambda x, *lv: body(x, [module_weights(c, n) for c, n in pairs], False),
                     lambda x, *lv: body(x, _weights_from(pairs, lv), True),
                     [x, *_leaves(pairs)], single=True)


def fused_stem_layer1(trunk, x: torch.Tensor) -> torch.Tensor:
    """The frozen-BN (context net) stem + layer1 of an encoder module, the
    BatchNorms folded into the conv weights: ``(1, H, W, 64)``."""
    return _chain(_layer1_convs(trunk), x,
                  lambda x, convs, plain: _trunk_passes(x, convs, False, plain))


def fused_in_stem_layer1(trunk, x: torch.Tensor) -> torch.Tensor:
    """The instance-norm (feature net) stem + layer1 of an encoder module
    for one ``(1, H, W, 3)`` image."""
    return _chain([(c, None) for c, _ in _layer1_convs(trunk)], x,
                  lambda x, convs, plain: _trunk_passes(x, convs, True, plain))


def _block_pairs(block, norm_fn: str):
    if norm_fn == "instance":
        return [(block.conv1, None), (block.conv2, None)]
    return [(block.conv1, block.norm1), (block.conv2, block.norm2)]


def stream_resblock(block, x: torch.Tensor, norm_fn: str) -> torch.Tensor:
    """A stride-1 identity-shortcut residual block as raw1 -> mid1 -> point2
    (the JAX package's ``stream_resblock``)."""
    instance = norm_fn == "instance"
    return _chain(_block_pairs(block, norm_fn), x,
                  lambda x, convs, plain: _resblock(x, convs, instance, False, plain))


def stream_resblock_q8(block, x: torch.Tensor, norm_fn: str) -> Lane8:
    """:func:`stream_resblock` whose point2 exit writes the int8 container
    (the JAX package's ``stream_resblock_q8``)."""
    convs = [module_weights(c, n) for c, n in _block_pairs(block, norm_fn)]
    return _resblock(x, convs, norm_fn == "instance", True)


def _resblock(x: torch.Tensor, convs: List[ConvWeights], instance: bool, quant: bool,
              plain: bool = False):
    op = _ops(plain)
    w1, w2 = convs
    n = x.shape[1] * x.shape[2]

    def mv(st):
        return stats_to_mv(st, n) if instance else (None, None)

    raw, st = op["pass"]("raw1", [(x, None, None)], w1, None, stats=instance)
    raw, st = op["pass"]("mid1", [(raw, *mv(st))], w2, None, stats=instance)
    return op["point2"](x, (raw, *mv(st)), norm=instance, quant=quant)


def stream_head_conv(conv, x: torch.Tensor) -> torch.Tensor:
    """A 3x3 pad-1 output-head conv as one raw1 pass (the JAX package's
    ``stream_head_conv``)."""
    return _chain([(conv, None)], x, lambda x, convs, plain: _ops(plain)["pass"](
        "raw1", [(x, None, None)], convs[0], None, stats=False)[0])


def stream_head_conv_q8(conv, x: torch.Tensor) -> Lane8:
    """:func:`stream_head_conv` with the quantize-on-exit pass: the conv
    output's int8 container (the JAX package's ``stream_head_conv_q8``)."""
    return conv_pass("raw1", [(x, None, None)], module_weights(conv), None, stats=False,
                     quant=True)[0]


# -- gates ------------------------------------------------------------------------
# They decide values only: bf16, one sample, identity shortcuts, the norm the
# chain reproduces. The JAX package's geometry gates (strip widths, row
# blocks, H >= 16, even W) exist for its compiler and memory and are not
# carried over: the kernels take every shape.


def _map_ok(x: torch.Tensor) -> bool:
    return x.ndim == 4 and x.shape[0] == 1 and x.dtype == torch.bfloat16


def _fusable(trunk, x: torch.Tensor, stride: int) -> bool:
    return (fused_encoders_on() and _map_ok(x) and stride == 1
            and all(blk.downsample is None for blk in trunk.layer1))


def stem_layer1_is_fusable(trunk, x: torch.Tensor, norm_fn: str, stride: int) -> bool:
    return norm_fn == "batch" and _fusable(trunk, x, stride)


def in_stem_layer1_is_fusable(trunk, x: torch.Tensor, norm_fn: str, stride: int) -> bool:
    return norm_fn == "instance" and _fusable(trunk, x, stride)


def resblock_streamable(block, x: torch.Tensor, norm_fn: str) -> bool:
    """A stride-1 identity-shortcut block over a ``(1, H, W, C)`` bf16 map."""
    if not (fused_encoders_on() and stream_tail_on() and norm_fn in ("batch", "instance")):
        return False
    ch = x.shape[-1]
    return (block.downsample is None and _map_ok(x)
            and tuple(block.conv1.weight.shape[:2]) == (ch, ch))


def head_conv_streamable(conv, x: torch.Tensor) -> bool:
    """A 3x3 pad-1 stride-1 head conv over a ``(1, H, W, C)`` bf16 map."""
    return (fused_encoders_on() and stream_tail_on() and _map_ok(x)
            and tuple(conv.weight.shape[1:]) == (x.shape[-1], 3, 3)
            and tuple(conv.stride) == (1, 1) and tuple(conv.padding) == (1, 1))


def resblock_q8_streamable(block, x: torch.Tensor, norm_fn: str) -> bool:
    """:func:`resblock_streamable` with ``RAFT_LANE_PACK8`` on. The JAX
    package's single-strip and ``W % 4`` rules are its container layout's
    and are not carried over."""
    return lane_pack8_on() and resblock_streamable(block, x, norm_fn)


def head_conv_q8_streamable(conv, x: torch.Tensor) -> bool:
    """:func:`head_conv_streamable` with ``RAFT_LANE_PACK8`` on."""
    return lane_pack8_on() and head_conv_streamable(conv, x)
