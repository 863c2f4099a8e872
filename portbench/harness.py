"""One run of one cell: set-up, the measured window, the correctness check,
the result line.

A run, in order:

1. The cell, its configuration, traffic mix, driver, metrics and limits,
   found by name (``spec.py``).
2. Set-up: the port's model built from the configuration and loaded with
   the weights made from the seed (``inputs.py``, through
   ``raft_stereo_tpu_torch.transplant.load_state_dict``), the kernels
   built, then the driver's own set-up and warm-up (its pairs, a session
   and service, every shape the window uses run once). ``setup_s`` runs
   from the start of the process to the first timed request.
3. The window: the driver's timed loop for ``--seconds``; with ``--trace 1``
   under ``torch.profiler`` (``trace.py``). ``memory_peak_bytes`` is read
   when it closes.
4. The port's state is freed; the float32 reference (``judge.py``) judges
   the driver's sampled answers; with ``--trace 1`` the flop count of a
   frame is taken from the reference on the meta device.
5. The metrics' readers (``metrics/<name>.py``) turn the run's record into
   the line's metrics.

Nothing here imports JAX or the JAX package; :func:`forbidden_modules`
checks the process for them before the line is printed.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import costs, inputs, judge, spec, trace
from portbench.costs import arch_of

# Top-level module names a run may not hold (JAX and the JAX package); the
# port's own name begins with the latter's, so names compare whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_stereo_tpu")


def process_age() -> float:
    """Seconds since this process started (its start time in /proc, on the
    clock /proc/uptime counts)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Sample:
    """A uniform sample of ``k`` answers of a stream of unknown length,
    drawn from a seed (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.seen = 0
        self.kept: List[judge.Answer] = []

    def offer(self, index: int, answer_fn) -> None:
        """Offer the answer of pool pair ``index``; ``answer_fn()`` gives the
        host array and is called only for an answer that is kept."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((index, answer_fn()))
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.kept[j] = (index, answer_fn())


class Context:
    """What a driver gets: the configuration and traffic mix, the port's
    model, the seeded streams, the device and the trace."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 profile: trace.Profile):
        self.config, self.traffic = config, traffic
        self.seeds = inputs.stream_seeds(seed)
        self.device = device
        self.profile = profile
        self.iters = int(config["valid_iters"])
        self.weights = inputs.make_weights(arch_of(config), self.seeds["weights"], device)
        self.model = self._port_model()
        self.sample = Sample(int(traffic["check_answers"]), self.seeds["sample"])

    def _port_model(self):
        from raft_stereo_tpu_torch.config import RAFTStereoConfig
        from raft_stereo_tpu_torch.models import RAFTStereo
        from raft_stereo_tpu_torch.transplant import load_state_dict
        cfg = RAFTStereoConfig(corr_implementation=self.config["corr_implementation"],
                               mixed_precision=self.config["mixed_precision"],
                               **arch_of(self.config))
        model = RAFTStereo(cfg).to(self.device).eval()
        load_state_dict(model, self.weights)
        if self.device.type == "cuda":
            from raft_stereo_tpu_torch import kernels
            kernels.build()
        return model

    def pairs(self, n: int, h: int, w: int) -> list:
        """The seeded pool of ``n`` uint8 (H, W, 3) pairs on the device."""
        return inputs.make_pairs(n, h, w, float(self.traffic["max_disp"]),
                                 self.seeds["pairs"], self.device)

    def order(self, n: int, length: int) -> np.ndarray:
        """A seeded sequence of ``length`` pool indices, every index of the
        pool once in each run of ``n``."""
        rng = np.random.default_rng(self.seeds["order"])
        return np.concatenate([rng.permutation(n) for _ in range(-(-length // n))])[:length]


def _finite(x):
    return x if x is None or np.isfinite(x) else None


def run(cell_name: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", bench: Optional[dict] = None,
        overrides: Optional[Dict[str, dict]] = None, whole_process: bool = False,
        keep: Optional[dict] = None) -> dict:
    """One run; returns the result line as a dict. ``overrides`` replaces
    keys of the cell's ``config``, ``traffic`` or ``limits`` (the CPU
    rehearsals' tiny sizes). ``setup_s`` counts from the start of the
    process with ``whole_process``, else from the call. ``keep``, a dict,
    receives what the study of the limits reads again (``study.py``): every
    number of the check, the answers, the reference's disparities, the
    weights and the pool."""
    overrides = overrides or {}
    bench = bench or spec.load_benchmark()
    cell = spec.cell(bench, cell_name)
    config = {**spec.config(cell["config"]), **overrides.get("config", {})}
    traffic = {**spec.traffic(cell["traffic"]), **overrides.get("traffic", {})}
    limits = {**spec.limits(cell_name), **overrides.get("limits", {})}
    driver = spec.driver(traffic["driver"])
    metrics = spec.cell_metrics(bench, cell_name, traced)
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in metrics}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_entry = time.perf_counter()

    profile = trace.Profile(traced, dev)
    ctx = Context(config, traffic, seed, dev, profile)
    runner = driver.Runner(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = process_age() if whole_process else time.perf_counter() - t_entry
    profile.start()
    window = runner.window(seconds)
    profile.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    rec = {"config": config, "traffic": traffic, "setup_s": setup_s,
           "memory_peak_bytes": peak, **window}
    device_rec = profile.reduce()
    if device_rec is not None:
        rec.update(device_rec)
    rec.update(runner.records())
    runner.close()
    del runner, ctx.model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The check, after the window and with the port's state freed.
    answers = ctx.sample.kept
    pool = window["pool"]
    model = judge.reference_model(arch_of(config), ctx.weights, dev)
    refs = judge.reference_disparities(model, lambda i: pool[i], [i for i, _ in answers],
                                       ctx.iters)
    del model
    values = judge.numbers(answers, refs)
    correct, checks = judge.verdict(values, limits)
    correct = correct and bool(answers) and window["failed"] == 0
    if keep is not None:
        keep.update(values=values, answers=answers, refs=refs, weights=ctx.weights, pool=pool,
                    arch=arch_of(config), iters=ctx.iters)
    if traced:
        ph, pw = costs.padded(int(traffic["height"]), int(traffic["width"]))
        rec["padded"] = (ph, pw)
        rec["flops_per_frame"] = costs.frame_flops(arch_of(config), ctx.iters, ph, pw)

    out_metrics = {}
    for m in metrics:
        value = readers[m["name"]](rec)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
            "metrics": out_metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                       "count": int(cell["chips"]), "memory_peak_bytes": peak or 0}}
    if traced and device_rec is not None:
        line["device"].update(busy_s=device_rec["busy_s"], window_s=device_rec["window_s"])
        line["breakdown"] = device_rec["breakdown"]
    line["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                      for k, v in checks.items()}
    return line
