"""Headline benchmark of the port: ``python -m raft_stereo_tpu_torch.bench``.

The JAX package's ``bench.py`` protocol, knobs and output keys, on the
port: disparity frames per second at the Middlebury-F size (2016x2976) with
32 refinement iterations, one pair a frame, on one card. Prints one JSON
line.

Env overrides (the JAX bench's names and defaults): ``RAFT_BENCH_H`` /
``RAFT_BENCH_W`` (2016 / 2976), ``RAFT_BENCH_ITERS`` (32),
``RAFT_BENCH_FRAMES`` (8 timed frames), ``RAFT_BENCH_CORR`` (``reg_tpu``,
the alias of ``reg_cuda``), ``RAFT_BENCH_BATCH`` (1), ``RAFT_BENCH_MP``
(bf16 on), ``RAFT_BENCH_TRACE`` (a directory for the profiled frame's
Chrome trace), and the architecture overrides ``RAFT_BENCH_SHARED``,
``RAFT_BENCH_DOWNSAMPLE``, ``RAFT_BENCH_GRU_LAYERS``,
``RAFT_BENCH_SLOW_FAST``; the reference's realtime model (its README) is
``RAFT_BENCH_SHARED=1 RAFT_BENCH_DOWNSAMPLE=3 RAFT_BENCH_GRU_LAYERS=2
RAFT_BENCH_SLOW_FAST=1 RAFT_BENCH_ITERS=7``. ``--device`` as the demo's: the
card unless ``--device cpu`` (the kernels' plain versions); no silent CPU
fallback.

The model has seeded random weights (``init_raft_stereo(cfg, seed=0)``,
untempered as the JAX bench's: the loop is chaotic, but its bits are the
same run to run, which the pins need); one pair, made
from ``np.random.default_rng(0)`` uniform in [0, 255], stays on the device.
Order of runs: a warm-up frame (it builds nothing: the kernels are built
before it, all sources at once) and a second one; one frame under
``torch.profiler`` for ``device_s``, the union of the card's busy intervals
(``obs/profiler.py``); then ``RAFT_BENCH_FRAMES`` frames dispatched back to
back, one ``torch.cuda.synchronize()`` and the checksum fetch:
``value = frames * batch / elapsed``.

Output keys: ``metric``, ``value``, ``unit`` (frames/s), ``vs_baseline``
(``BASELINE.json``'s published fps, else ``baseline_measured.json``'s torch
CPU datum at this size, at batch 1 only), ``checksum`` and ``sum_abs``
(sums of the last frame's ``flow_up`` and of its magnitude), ``device_s``,
``flops`` (``FlopCounterMode`` over the fp32 ``reg`` twin on the meta device,
the whole program at its iterations: ``obs/ledger.py``), ``mfu`` (read off
the ledger row: flops over ``device_s`` over the card's peak), ``peak_hbm_bytes``
(``max_memory_allocated`` over the timed frames), ``roofline`` and ``bytes``
(absent: no byte count), ``corr_dma`` and ``lane_dma`` (:func:`corr_dma`,
:func:`lane_dma`). A value that cannot be had is ``null``.

The checksums are held to pins in ``bench_checksum_ref.json`` beside this
file (:func:`check_checksum_pin`), keyed ``cuda:...`` or ``cpu:...``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig, resolve_device
from raft_stereo_tpu_torch.models import RAFTStereo, init_raft_stereo, raft_stereo_forward

REPO = Path(__file__).resolve().parents[1]
PIN_PATH = Path(__file__).resolve().with_name("bench_checksum_ref.json")

# Band of a newly pinned statistic, the JAX bench's: 0.5% of the pinned
# value, with an absolute floor of 1.0 for a sum near zero.
PIN_RTOL = 0.005
PIN_ATOL = 1.0

_OFF = ("0", "false", "no", "off")


def _env_flag(name: str, default: str) -> bool:
    return os.environ.get(name, default).strip().lower() not in _OFF


def check_checksum_pin(key: str, checksum: float, sum_abs: float,
                       path: Optional[Path] = None) -> None:
    """Hold the disparity checksums to their pinned band in ``path``
    (default :data:`PIN_PATH`), the JAX bench's rules. An existing statistic
    is always enforced and moves only under ``RAFT_BENCH_REBASELINE=1``. A
    missing entry or statistic is recorded only under
    ``RAFT_BENCH_AUTOPIN=1``, which never overwrites; a bare run warns and
    never writes the file. An unreadable pin file raises."""
    path = Path(path or PIN_PATH)
    refs = {}
    if path.exists():
        refs = json.loads(path.read_text())

    def write(msg):
        path.write_text(json.dumps(refs, indent=1, sort_keys=True) + "\n")
        print(msg, file=sys.stderr)

    if os.environ.get("RAFT_BENCH_REBASELINE"):
        refs[key] = {"checksum": checksum, "sum_abs": sum_abs, "rtol": PIN_RTOL,
                     "atol": PIN_ATOL}
        write(f"bench: re-baselined checksum for {key}: {checksum:.2f} "
              f"(sum|d| {sum_abs:.2f})")
        return
    autopin = _env_flag("RAFT_BENCH_AUTOPIN", "0")
    ref = refs.get(key)
    if ref is None:
        if autopin:
            refs[key] = {"checksum": checksum, "sum_abs": sum_abs, "rtol": PIN_RTOL,
                         "atol": PIN_ATOL}
            write(f"bench: PINNED (new config) {key}: checksum {checksum:.2f}, "
                  f"sum|d| {sum_abs:.2f} — now enforced")
        else:
            print(f"bench: no pinned checksum for {key}; RAFT_BENCH_AUTOPIN=1 "
                  "records one", file=sys.stderr)
        return
    for name, got in (("checksum", checksum), ("sum_abs", sum_abs)):
        pinned = ref.get(name)
        if pinned is None:
            if autopin:
                refs[key][name] = got
                write(f"bench: PINNED (new statistic) {key}.{name} = {got:.2f} "
                      "— now enforced")
            continue
        tol = max(abs(pinned) * ref.get("rtol", PIN_RTOL), ref.get("atol", PIN_ATOL))
        if abs(got - pinned) > tol:
            raise AssertionError(
                f"disparity {name} {got:.2f} outside the pinned band {pinned:.2f} "
                f"±{tol:.2f} for {key}; if the numerics change is intentional, "
                "re-baseline with RAFT_BENCH_REBASELINE=1")


def pin_key(cfg: RAFTStereoConfig, h: int, w: int, iters: int, batch: int,
            backend: str) -> str:
    """The checksum pin's key: backend, geometry, correlation, precision,
    batch and architecture."""
    return (f"{backend}:{h}x{w}_i{iters}_{cfg.corr_kind}_"
            f"{'bf16' if cfg.mixed_precision else 'fp32'}_b{batch}{arch_tag(cfg)}")


def arch_tag(cfg: RAFTStereoConfig) -> str:
    return (f"_sh{cfg.shared_backbone:d}_d{cfg.n_downsample}_g{cfg.n_gru_layers}"
            f"_sf{cfg.slow_fast_gru:d}")


def card_name(device: torch.device) -> str:
    """The card's short name for metric keys (``h100`` for "NVIDIA H100
    80GB HBM3"), ``cpu`` on the CPU."""
    if device.type != "cuda":
        return device.type
    name = torch.cuda.get_device_name(device)
    m = re.search(r"\b([A-Z]{1,2}\d{2,4})\b", name)
    return (m.group(1) if m else re.sub(r"\W+", "_", name)).lower()


def _level_sizes(h: int, w: int, cfg: RAFTStereoConfig):
    """(H, W) of each GRU level's map: 1/f of the frame, then halved by
    stride-2 convs (ceil) per coarser level."""
    hh, ww = h // cfg.downsample_factor, w // cfg.downsample_factor
    sizes = []
    for _ in range(cfg.n_gru_layers):
        sizes.append((hh, ww))
        hh, ww = (hh + 1) // 2, (ww + 1) // 2
    return sizes


def _ratio_doc(h: int, w: int, bf16: int, int8: int) -> Dict:
    return {"h": h, "w": w, "bf16_bytes_per_iter": bf16, "int8_bytes_per_iter": int8,
            "int8_over_bf16": round(int8 / bf16, 4)}


def corr_dma(cfg: RAFTStereoConfig, h: int, w: int) -> Dict:
    """Pyramid bytes the lookup (the resident kernel's stage 1) reads an
    iteration for one sample: 2r+2 taps a level and pixel
    (``csrc/corr_taps.cuh``), bf16 levels against int8 ones
    (``RAFT_CORR_PACK8``, plus a (sample, level) fp32 scale a level)."""
    (hh, ww), = _level_sizes(h, w, dataclasses.replace(cfg, n_gru_layers=1))
    taps = cfg.corr_levels * (2 * cfg.corr_radius + 2) * hh * ww
    return _ratio_doc(h, w, 2 * taps, taps + 4 * cfg.corr_levels)


def gru_steps(cfg: RAFTStereoConfig):
    """Steps a GRU level takes an iteration, finest first: the slow-fast
    pre-steps step gru32 twice more (3 levels) and gru16 once more."""
    n = cfg.n_gru_layers
    extra = ((0, 1, 2) if n == 3 else (0, 1, 0)) if cfg.slow_fast_gru else (0, 0, 0)
    return tuple(1 + extra[i] for i in range(n))


def lane_dma(cfg: RAFTStereoConfig, h: int, w: int) -> Dict:
    """czrq bytes the GRU kernels read an iteration for one sample: each
    level's (H, W, 3 ch) context once a step, bf16 against int8 containers
    (``RAFT_LANE_PACK8``, plus an fp32 scale)."""
    bf16 = int8 = 0
    for (hh, ww), ch, steps in zip(_level_sizes(h, w, cfg), cfg.hidden_dims[::-1],
                                   gru_steps(cfg)):
        n = hh * ww * 3 * ch
        bf16 += steps * 2 * n
        int8 += steps * (n + 4)
    return _ratio_doc(h, w, bf16, int8)


def plain_twin(cfg: RAFTStereoConfig, batch: int, h: int, w: int, iters: int):
    """The program's plain twin on the meta device, which allocates nothing:
    the fp32 ``reg`` forward at the same architecture and size, whose every
    operation the flop counter sees (the kernels are opaque to it)."""
    twin_cfg = dataclasses.replace(cfg, corr_implementation="reg", mixed_precision=False)
    with torch.device("meta"):
        model = RAFTStereo(twin_cfg).eval()
        image = torch.zeros((batch, h, w, 3))
    return lambda: raft_stereo_forward(model, image, image, iters=iters)


def _baseline(h: int, w: int, iters: int, batch: int) -> Optional[float]:
    """A published reference fps, else the measured torch-reference CPU
    datum at this size; single-frame protocols, so at batch 1 only."""
    if batch != 1:
        return None
    for name, key in (("BASELINE.json", None),
                      ("baseline_measured.json", f"torch_cpu_fps_{h}x{w}_{iters}iters")):
        try:
            doc = json.loads((REPO / name).read_text())
        except (OSError, ValueError):
            continue
        value = doc.get("published", {}).get("fps") if key is None else doc.get(key)
        if value:
            return float(value)
    return None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m raft_stereo_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the kernels' "
                   "plain torch versions)")
    return p


def main(argv=None) -> None:
    from raft_stereo_tpu_torch import kernels
    from raft_stereo_tpu_torch.obs.ledger import ProgramLedger, analyze_program, chip_peaks
    from raft_stereo_tpu_torch.obs.profiler import profile_device_seconds

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    h = int(os.environ.get("RAFT_BENCH_H", 2016))
    w = int(os.environ.get("RAFT_BENCH_W", 2976))
    iters = int(os.environ.get("RAFT_BENCH_ITERS", 32))
    n_frames = int(os.environ.get("RAFT_BENCH_FRAMES", 8))
    batch = int(os.environ.get("RAFT_BENCH_BATCH", 1))
    cfg = RAFTStereoConfig(
        corr_implementation=os.environ.get("RAFT_BENCH_CORR", "reg_tpu"),
        mixed_precision=_env_flag("RAFT_BENCH_MP", "1"),
        shared_backbone=_env_flag("RAFT_BENCH_SHARED", "0"),
        n_downsample=int(os.environ.get("RAFT_BENCH_DOWNSAMPLE", "2")),
        n_gru_layers=int(os.environ.get("RAFT_BENCH_GRU_LAYERS", "3")),
        slow_fast_gru=_env_flag("RAFT_BENCH_SLOW_FAST", "0"))
    precision = "bf16" if cfg.mixed_precision else "fp32"
    on_card = device.type == "cuda"
    device_kind = torch.cuda.get_device_name(device) if on_card else device.type

    model = init_raft_stereo(cfg, seed=0, device=device)
    if on_card:
        kernels.build()  # every source at once, before the first frame
    rng = np.random.default_rng(0)
    img1, img2 = (torch.from_numpy(rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32))
                  .to(device) for _ in range(2))

    def frame(image1, image2):
        with torch.inference_mode():
            _, flow_up = raft_stereo_forward(model, image1, image2, iters=iters)
            return flow_up.sum(), flow_up.abs().sum()

    def fetch(sums):
        checksum, sum_abs = (float(s) for s in sums)
        if not (np.isfinite(checksum) and np.isfinite(sum_abs)):
            raise AssertionError(f"non-finite disparity checksum {checksum} / {sum_abs}")
        return checksum, sum_abs

    # The first frame, accounted: its memory on the card, and the flops of
    # the plain twin at the same size and iterations.
    ledger = ProgramLedger()
    ledger_key = ("bench_full", batch, h, w, iters, cfg.corr_kind)
    analysis = analyze_program(frame, img1, img2, twin=plain_twin(cfg, batch, h, w, iters))
    row = ledger.record(ledger_key, kind="full", b=batch, h=h, w=w, iters=iters,
                        scan_scale=1, analysis=analysis, backend=device.type,
                        device_kind=device_kind)
    fetch(frame(img1, img2))

    trace_dir = os.environ.get("RAFT_BENCH_TRACE")
    device_s = profile_device_seconds(
        lambda: fetch(frame(img1, img2)),
        os.path.join(trace_dir, "bench_frame.json") if trace_dir else None)

    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    pending = [frame(img1, img2) for _ in range(n_frames)]
    if on_card:
        torch.cuda.synchronize(device)
    checksum = sum_abs = None
    for sums in pending:
        checksum, sum_abs = fetch(sums)
    elapsed = time.perf_counter() - t0
    peak_hbm = torch.cuda.max_memory_allocated(device) if on_card else None
    fps = n_frames * batch / elapsed

    check_checksum_pin(pin_key(cfg, h, w, iters, batch, device.type), checksum, sum_abs)

    baseline = _baseline(h, w, iters, batch)
    peaks = chip_peaks(device_kind)
    dispatch_s = device_s if device_s else elapsed / n_frames
    flops = row.flops_est
    mfu = flops / dispatch_s / peaks[0] if flops and peaks else None
    corr_doc = {"bench": corr_dma(cfg, h, w), "headline": corr_dma(cfg, 2016, 2976)}
    lane_doc = {"bench": lane_dma(cfg, h, w), "headline": lane_dma(cfg, 2016, 2976)}
    overridden = arch_tag(cfg) != arch_tag(RAFTStereoConfig())
    doc = {
        "metric": (f"middlebury_F_disparity_fps_{card_name(device)}_{iters}iters_{h}x{w}_"
                   f"{cfg.corr_kind}_{precision}" + (arch_tag(cfg) if overridden else "")
                   + (f"_batch{batch}" if batch > 1 else "")),
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline, 4) if baseline else None,
        "checksum": round(checksum, 2),
        "sum_abs": round(sum_abs, 2),
        "device_s": round(device_s, 6) if device_s else None,
        "flops": flops,
        "mfu": round(mfu, 4) if mfu else None,
        "peak_hbm_bytes": peak_hbm,
        "roofline": row.roofline(peaks),
        "bytes": row.bytes_accessed,
        "corr_dma": corr_doc,
        "lane_dma": lane_doc,
    }
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
