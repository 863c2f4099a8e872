"""Validation: ETH3D, KITTI, FlyingThings, Middlebury (the JAX package's
``engine/evaluate.py``, reference ``evaluate_stereo.py:18-189``), on the
port's test-mode forward with ``ops/padder.py``. The validators keep the
JAX package's ``(model, cfg, ...)`` signature; the model carries its
config, so ``cfg`` is not read.

The metrics keep the reference's quirks: ETH3D 1 px outliers averaged per
image; KITTI 3 px (D1) aggregated per pixel, its frame rate from frames 52
on; FlyingThings (finalpass TEST, the seed-1000 400-image subset) 1 px with
``|flow_gt| < 192``, per pixel; Middlebury 2 px per image with the validity
``(valid >= -0.5) & (flow_gt > -1000)`` (the nocc mask is in effect
ignored, as in the reference). A forward's time is taken on the host around
the call and a synchronize.

``mesh`` (a ``parallel.ProcessGrid`` with a space axis; ``--spatial_shard``)
splits each frame's height over the ranks of the space row, as the JAX
package's spatial evaluation does: every rank runs the validator over the
same samples, the forward on its rows, and the disparity is gathered over
the row before the metrics. ``segments > 1`` is refused with it, as in the
JAX package.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from raft_stereo_tpu_torch.data import datasets
from raft_stereo_tpu_torch.models.raft_stereo import raft_stereo_inference
from raft_stereo_tpu_torch.ops.padder import InputPadder

logger = logging.getLogger(__name__)


def count_parameters(model: torch.nn.Module) -> int:
    """Trainable parameters (the reference's count)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def make_eval_forward(model, iters: int, mixed_prec: bool = False, segments: int = 1,
                      mesh=None):
    """``forward(image1, image2) -> (flow_up (1, H, W, 1) numpy, seconds)``
    for one padded host pair, on the model's device. ``mixed_prec`` runs the
    model in bf16, else in fp32 (the config's ``mixed_precision`` is set to it
    for the call, as the JAX package's validators do). Under ``mesh`` the
    whole map, gathered over the space row."""
    from raft_stereo_tpu_torch.parallel.mesh import space_mesh_of
    if segments > 1 and mesh is not None:
        raise ValueError("segments > 1 is not supported with --spatial_shard")
    space = space_mesh_of(mesh)
    device = next(model.parameters()).device

    def forward(image1: np.ndarray, image2: np.ndarray):
        d1 = torch.from_numpy(np.ascontiguousarray(image1)).to(device)
        d2 = torch.from_numpy(np.ascontiguousarray(image2)).to(device)
        saved = model.cfg.mixed_precision
        model.cfg.mixed_precision = bool(mixed_prec)
        try:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with torch.no_grad():
                _, flow_up = raft_stereo_inference(model, d1, d2, iters=iters,
                                                   segments=segments, space=space)
                if space is not None:
                    flow_up = space.gather_rows(flow_up)
            out = flow_up.float().cpu().numpy()
            elapsed = time.perf_counter() - t0
        finally:
            model.cfg.mixed_precision = saved
        return out, elapsed

    return forward


def _epe_map(flow_pr: np.ndarray, flow_gt: np.ndarray) -> np.ndarray:
    if flow_pr.shape != flow_gt.shape:
        raise AssertionError((flow_pr.shape, flow_gt.shape))
    return np.sqrt(np.sum((flow_pr - flow_gt) ** 2, axis=-1))


def prefetch_samples(dataset):
    """``dataset[i]`` for every i, decoding sample i+1 on a background
    thread while the caller runs the forward."""
    from concurrent.futures import ThreadPoolExecutor
    if len(dataset) == 0:
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(dataset.__getitem__, 0)
        for i in range(1, len(dataset) + 1):
            sample = fut.result()
            if i < len(dataset):
                fut = ex.submit(dataset.__getitem__, i)
            yield sample


def _run_pair(forward, sample, bucket: Optional[int]):
    image1 = sample["image1"][None]
    image2 = sample["image2"][None]
    padder = InputPadder(image1.shape, divis_by=32, bucket=bucket)
    image1, image2 = padder.pad_np(image1, image2)
    flow_pr, elapsed = forward(image1, image2)
    return padder.unpad_np(flow_pr)[0], elapsed


def validate_eth3d(model, cfg=None, iters: int = 32, mixed_prec: bool = False,
                   root: Optional[str] = None, bucket: Optional[int] = None,
                   segments: int = 1, mesh=None) -> Dict[str, float]:
    """ETH3D train split: EPE and D1 (> 1 px), averaged per image."""
    kw = {"root": f"{root}/ETH3D"} if root else {}
    val_dataset = datasets.ETH3D(aug_params=None, **kw)
    forward = make_eval_forward(model, iters, mixed_prec, segments=segments, mesh=mesh)
    out_list, epe_list = [], []
    for val_id, sample in enumerate(prefetch_samples(val_dataset)):
        flow_pr, _ = _run_pair(forward, sample, bucket)
        epe = _epe_map(flow_pr, sample["flow"]).flatten()
        val = sample["valid"].flatten() >= 0.5
        image_out = (epe > 1.0)[val].mean()
        image_epe = epe[val].mean()
        logger.info("ETH3D %d out of %d. EPE %.4f D1 %.4f", val_id + 1, len(val_dataset),
                    image_epe, image_out)
        epe_list.append(image_epe)
        out_list.append(image_out)
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.mean(out_list))
    print("Validation ETH3D: EPE %f, D1 %f" % (epe, d1))
    return {"eth3d-epe": epe, "eth3d-d1": d1}


def validate_kitti(model, cfg=None, iters: int = 32, mixed_prec: bool = False,
                   root: Optional[str] = None, bucket: Optional[int] = None,
                   segments: int = 1, mesh=None) -> Dict[str, float]:
    """KITTI-2015 train split: EPE and D1 (> 3 px, per pixel), and the frame
    rate over frames 52 on; decode stays serial, outside the timed call."""
    kw = {"root": f"{root}/KITTI"} if root else {}
    val_dataset = datasets.KITTI(aug_params=None, image_set="training", **kw)
    forward = make_eval_forward(model, iters, mixed_prec, segments=segments, mesh=mesh)
    out_list, epe_list, elapsed_list = [], [], []
    for val_id in range(len(val_dataset)):
        sample = val_dataset.__getitem__(val_id)
        flow_pr, elapsed = _run_pair(forward, sample, bucket)
        if val_id > 50:
            elapsed_list.append(elapsed)
        epe = _epe_map(flow_pr, sample["flow"]).flatten()
        val = sample["valid"].flatten() >= 0.5
        out = epe > 3.0
        image_epe = epe[val].mean()
        logger.info("KITTI Iter %d out of %d. EPE %.4f D1 %.4f. Runtime: %.3fs (%.2f-FPS)",
                    val_id + 1, len(val_dataset), image_epe, out[val].mean(), elapsed,
                    1 / elapsed)
        epe_list.append(image_epe)
        out_list.append(out[val])
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.mean(np.concatenate(out_list)))
    avg_runtime = float(np.mean(elapsed_list)) if elapsed_list else float("nan")
    print(f"Validation KITTI: EPE {epe}, D1 {d1}, {1 / avg_runtime:.2f}-FPS "
          f"({avg_runtime:.3f}s)")
    return {"kitti-epe": epe, "kitti-d1": d1, "kitti-fps": 1 / avg_runtime}


def validate_things(model, cfg=None, iters: int = 32, mixed_prec: bool = False,
                    root: Optional[str] = None, bucket: Optional[int] = None,
                    segments: int = 1, mesh=None) -> Dict[str, float]:
    """FlyingThings3D finalpass TEST subset: EPE and D1 (> 1 px,
    ``|gt| < 192``), per pixel."""
    kw = {"root": root} if root else {}
    val_dataset = datasets.SceneFlowDatasets(aug_params=None, dstype="frames_finalpass",
                                             things_test=True, **kw)
    forward = make_eval_forward(model, iters, mixed_prec, segments=segments, mesh=mesh)
    out_list, epe_list = [], []
    for sample in prefetch_samples(val_dataset):
        flow_pr, _ = _run_pair(forward, sample, bucket)
        epe = _epe_map(flow_pr, sample["flow"]).flatten()
        val = ((sample["valid"].flatten() >= 0.5)
               & (np.abs(sample["flow"]).max(axis=-1).flatten() < 192))
        epe_list.append(epe[val].mean())
        out_list.append((epe > 1.0)[val])
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.mean(np.concatenate(out_list)))
    print("Validation FlyingThings: %f, %f" % (epe, d1))
    return {"things-epe": epe, "things-d1": d1}


def validate_middlebury(model, cfg=None, iters: int = 32, split: str = "F",
                        mixed_prec: bool = False, root: Optional[str] = None,
                        bucket: Optional[int] = None, segments: int = 1,
                        mesh=None) -> Dict[str, float]:
    """Middlebury V3: EPE and D1 (> 2 px), averaged per image."""
    kw = {"root": f"{root}/Middlebury"} if root else {}
    val_dataset = datasets.Middlebury(aug_params=None, split=split, **kw)
    forward = make_eval_forward(model, iters, mixed_prec, segments=segments, mesh=mesh)
    out_list, epe_list = [], []
    for val_id, sample in enumerate(prefetch_samples(val_dataset)):
        flow_pr, _ = _run_pair(forward, sample, bucket)
        epe = _epe_map(flow_pr, sample["flow"]).flatten()
        val = ((sample["valid"].reshape(-1) >= -0.5)
               & (sample["flow"][..., 0].reshape(-1) > -1000))
        image_out = (epe > 2.0)[val].mean()
        image_epe = epe[val].mean()
        logger.info("Middlebury Iter %d out of %d. EPE %.4f D1 %.4f", val_id + 1,
                    len(val_dataset), image_epe, image_out)
        epe_list.append(image_epe)
        out_list.append(image_out)
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.mean(out_list))
    print(f"Validation Middlebury{split}: EPE {epe}, D1 {d1}")
    return {f"middlebury{split}-epe": epe, f"middlebury{split}-d1": d1}


VALIDATORS: Dict[str, Callable] = {
    "eth3d": validate_eth3d,
    "kitti": validate_kitti,
    "things": validate_things,
    "middlebury": validate_middlebury,
}
