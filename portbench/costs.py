"""The yardstick's arithmetic: the chip's peaks, the model's operations a
frame, and the operations and bytes of the loop kernels' work.

- Peaks: NVIDIA's data sheet for the H100 SXM, dense rates: 989e12 FLOP/s
  in bf16 on the tensor cores, 3.35e12 bytes/s of HBM3 (the port's
  ``obs/ledger.py`` ``PEAK_FLOPS`` / ``PEAK_HBM_BW``).
- A frame's operations: ``torch.utils.flop_counter.FlopCounterMode`` over
  this package's float32 reference (``reference/raft_stereo.py``) on the
  meta device, at the padded frame size and the iterations the cell runs:
  the convolutions' and matrix products' multiply-adds, two operations
  each. Elementwise work is not counted.
- The resident iteration kernel (``csrc/resident.cu``: lookup, motion
  encoder, gru08 and the flow head's dx, one row-iteration) and the gru16+32
  kernel (``csrc/gru1632.cu``: gru32 then gru16): the operations the layers
  need and the bytes each input is read and each output written once, as
  the port's ``chip_smoke.py`` ``check_resident`` and ``check_gru1632``
  count them. The kernel's bound is the larger of operations over the
  bf16 peak and bytes over the bandwidth.
"""

from __future__ import annotations

from typing import Tuple

import torch

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# A configuration's architecture, as the reference and the port take it.
ARCH_KEYS = ("hidden_dims", "n_gru_layers", "n_downsample", "corr_levels", "corr_radius",
             "shared_backbone", "slow_fast_gru")


def arch_of(config: dict) -> dict:
    return {k: config[k] for k in ARCH_KEYS}


def padded(h: int, w: int, divis_by: int = 32) -> Tuple[int, int]:
    """The frame size the reference's and the port's padders give."""
    return -(-h // divis_by) * divis_by, -(-w // divis_by) * divis_by


def frame_flops(arch: dict, iters: int, ph: int, pw: int) -> float:
    """Operations of one test-mode frame at the padded size ``ph x pw``."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.raft_stereo import RAFTStereo
    with torch.device("meta"):
        model = RAFTStereo(arch)
        image = torch.empty((1, 3, ph, pw))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(image, image, iters)
    return float(counter.get_total_flops())


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take for the work."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _gru_macs(ch: int, cx: int) -> int:
    """MACs a pixel of one ConvGRU step: gates over [h; x], q over r*h."""
    return 9 * (cx * 3 * ch + ch * 2 * ch + ch * ch)


def feature_size(arch: dict, ph: int, pw: int) -> Tuple[int, int]:
    """(H, W) of the finest GRU level of a padded frame."""
    f = 2 ** arch["n_downsample"]
    return ph // f, pw // f


def resident_cost(arch: dict, h: int, w: int) -> Tuple[float, float]:
    """(operations, bytes) of one resident-kernel iteration of one row whose
    finest level is ``h x w``: the lookup of ``levels`` x ``2r+2`` bf16 taps
    a pixel, the motion encoder (flow y is zero, so only flow x's weights of
    the 7x7 conv), gru08 over [motion; upsampled gru16 state], and dx."""
    ch = arch["hidden_dims"][2]
    cx2 = arch["hidden_dims"][1] if arch["n_gru_layers"] > 1 else 0
    planes = arch["corr_levels"] * (2 * arch["corr_radius"] + 1)
    taps = arch["corr_levels"] * (2 * arch["corr_radius"] + 2)
    npix = h * w
    motion = planes * 64 + 49 * 64 + 2 * 9 * 64 * 64 + 9 * 128 * 126
    macs = npix * (motion + _gru_macs(ch, 128 + cx2) + 9 * (ch * 256 + 256))
    wbytes = 2 * (planes * 64 + 49 * 64 + 9 * 128 * 128 + 9 * 128 * 126
                  + 9 * 3 * ch * (ch + 128 + cx2) + 9 * ch * ch + 9 * ch * 256 + 9 * 256)
    # coords fp32, the taps, flow bf16 x2; h and x2 in, h' out (bf16); dx
    # fp32; czrq (3 ch) bf16.
    nbytes = npix * (4 + taps * 2 + 2 * 2 + 2 * (ch + cx2) + 2 * ch + 4 + 3 * ch * 2) + wbytes
    return 2.0 * macs, float(nbytes)


def gru1632_cost(arch: dict, h: int, w: int) -> Tuple[float, float]:
    """(operations, bytes) of one gru16+32 launch for one row whose finest
    level is ``h x w`` (gru16 at h/2 x w/2, gru32 at h/4 x w/4)."""
    ch = arch["hidden_dims"][1]
    n16 = (h // 2) * (w // 2)
    n32 = (h // 4) * (w // 4)
    macs = n32 * _gru_macs(ch, ch) + n16 * _gru_macs(ch, 2 * ch)
    wbytes = 2 * (9 * (2 * ch) * 3 * ch + 9 * (3 * ch) * 3 * ch + 2 * 9 * ch * ch)
    nbytes = (n16 + n32) * (2 * (ch + ch + ch) + 3 * ch * 2) + wbytes
    return 2.0 * macs, float(nbytes)
