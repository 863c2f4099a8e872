"""Whether the timed path's answers are right: each sampled answer against
the float32 reference's disparity of the same pair.

The reference runs after the window, once for each distinct pair among the
sampled answers, on the run's device with TF32 off, from the seeded weights
(never from the port). Its numbers, each the worst over the sampled
answers:

- ``mean_abs_px``: the mean over the frame of |port - reference| px;
- ``max_abs_px``: the largest |port - reference| px of any pixel;
- ``p99_abs_px``, ``bad1_pct``: the 99th percentile of |port - reference|
  and the share of pixels more than 1 px off, kept for the study of the
  limits (``study.py``).

A cell's ``limits/<cell>.json`` names the numbers it compares and their
limits; an answer that is missing, of another shape or not finite reads
infinity.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import raft_stereo as ref

# (pool index, the port's disparity (H, W) on the host)
Answer = Tuple[int, Optional[np.ndarray]]


def reference_model(arch: dict, weights: Dict[str, torch.Tensor], device,
                    lower: bool = False) -> ref.RAFTStereo:
    """The float32 reference on ``device`` holding ``weights``; with
    ``lower`` the control (``reference/fp8.py``)."""
    model = ref.RAFTStereo(arch).to(device).eval()
    model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    if lower:
        from portbench.reference.fp8 import lower_precision
        lower_precision(model)
    return model


def reference_disparities(model, pairs: Callable[[int], tuple], indices: Sequence[int],
                          iters: int) -> Dict[int, np.ndarray]:
    """The reference's disparity of each pool pair in ``indices``, with TF32
    off. cuDNN is off too: its float32 convolutions at 2016x2976 took 23.6 s
    a frame on the H100 (millions of small GEMV launches), ATen's own
    (im2col and a cuBLAS SGEMM) 2.9 s, the two 6e-4 px apart."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            out = {}
            for i in sorted(set(indices)):
                left, right = pairs(i)
                out[i] = ref.disparity(model, left, right, iters).float().cpu().numpy()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def numbers(answers: List[Answer], refs: Dict[int, np.ndarray]) -> Dict[str, float]:
    """Each number of the module docstring over ``answers``."""
    out = {"mean_abs_px": 0.0, "max_abs_px": 0.0, "p99_abs_px": 0.0, "bad1_pct": 0.0}
    for i, got in answers:
        want = refs[i]
        if got is None or got.shape != want.shape or not np.isfinite(got).all():
            return {k: math.inf for k in out}
        err = np.abs(got.astype(np.float64) - want)
        out["mean_abs_px"] = max(out["mean_abs_px"], float(err.mean()))
        out["max_abs_px"] = max(out["max_abs_px"], float(err.max()))
        out["p99_abs_px"] = max(out["p99_abs_px"], float(np.percentile(err, 99)))
        out["bad1_pct"] = max(out["bad1_pct"], 100.0 * float((err > 1.0).mean()))
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """``correct`` and each compared number beside its limit."""
    checks = {name: {"value": values[name], "limit": limit} for name, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
