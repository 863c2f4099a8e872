"""Rank processes for the port's multi-process CPU tests (gloo).

``python tests/torch_ranks.py <spec.json>`` runs one rank of a scenario; the
launch contract is the port's (``COORDINATOR_ADDRESS``, ``PROCESS_ID``,
``NUM_PROCESSES``). The spec names the scenario, an input directory the
test wrote (``inputs.pt``: state dicts and numpy arrays) and the output
directory, where each rank writes ``rank<r>.pt``: a dict of numpy arrays
and floats. :func:`launch` starts the ranks from a test; it imports no JAX,
and neither do the ranks.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


_PORTS_GIVEN = set()


def free_port() -> int:
    """A free TCP port on localhost, never one this process handed out
    before (the launches of one test file start at once)."""
    while True:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if port not in _PORTS_GIVEN:
            _PORTS_GIVEN.add(port)
            return port


def launch(scenario: str, world: int, in_dir, out_dir, timeout: float = 300.0,
           extra_env=None):
    """Start ``world`` rank processes of ``scenario``; returns a callable
    that waits for them, asserts each exited 0 and returns the ranks'
    outputs (a list of dicts, by rank). Its ``procs`` are the processes, for
    a caller that must stop them after a failure of its own."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = out_dir / "spec.json"
    spec.write_text(json.dumps({"scenario": scenario, "in": str(in_dir), "out": str(out_dir)}))
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
                   COORDINATOR_ADDRESS=f"localhost:{port}", PROCESS_ID=str(rank),
                   NUM_PROCESSES=str(world), **(extra_env or {}))
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__)), str(spec)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    t_end = time.monotonic() + timeout

    def wait():
        import torch
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=max(1.0, t_end - time.monotonic()))
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for rank, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
        return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]

    wait.procs = procs
    return wait


# The grid train steps' model and optimizer (lr 1e-4 as in the JAX
# package's tests/test_parallel.py, whose tolerances the steps are held to).
TRAIN = dict(hidden_dims=(32, 32, 32), n_gru_layers=2, corr_levels=2, corr_radius=2)
TRAIN_ITERS = 3
TRAIN_OPT = (1e-4, 100, 1e-5)  # lr, num_steps, wdecay
# Per-leaf relative L2 of a grid step's gradients against the one-process
# gradients of the same batch, the denominator floored at 1e-2 of the
# largest leaf's norm (the repo's rule), fp32. The stems' gradients sum a
# full-resolution map with heavy cancellation, so their fp32 rounding moves
# with the order the convolutions' threads sum in: most runs read 3.1-5.1e-6
# (fnet.conv1.weight), one run in twelve under load 1.4e-4
# (cnet.conv1.weight). A mean over the ranks in place of the sum, or a mean
# of the shards' means, reads 1e-2 or more.
GRID_GRAD_BAND = 1e-3


def train_batch() -> dict:
    """The grid train steps' global batch: B=2, 64x64; the top half of the
    height holds more valid pixels than the bottom half, so the two height
    shards' counts differ and a mean of the shards' means would show."""
    import numpy as np
    rng = np.random.default_rng(5)
    b, h, w = 2, 64, 64
    u = rng.uniform(size=(b, h, w))
    valid = np.where(np.arange(h)[None, :, None] < h // 2, u > 0.1, u > 0.6)
    return {"image1": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "flow": -rng.uniform(0, 8, (b, h, w, 1)).astype(np.float32),
            "valid": valid.astype(np.float32)}


# -- the ranks' side -----------------------------------------------------------


def _np(t):
    return t.detach().float().cpu().numpy()


def _grads(module):
    return {n: p.grad for n, p in module.named_parameters() if p.grad is not None}


def scenario_halo(inp, out):
    """The exchange (forward, and its backward in fp64), the sharded
    align-corners resize and the sharded pool, on a 4-rank world as one
    4-way space row and as two 2-way rows; one train step on the (2, 2)
    grid."""
    import torch

    from raft_stereo_tpu_torch.ops.halo import exchange_halo
    from raft_stereo_tpu_torch.ops.pooling import pool2x
    from raft_stereo_tpu_torch.ops.resize import interp_align_corners
    from raft_stereo_tpu_torch.parallel import make_mesh
    for ns, grid in ((4, make_mesh(1, 4)), (2, make_mesh(2, 2))):
        s = grid.space_index
        x = torch.from_numpy(inp["halo_x"])
        for k in inp["halo_ks"][ns]:
            local = x[:, grid.rows(x.shape[1])].clone().requires_grad_(True)
            ext = exchange_halo(local, k, grid)
            cot = torch.from_numpy(inp[f"halo_cot_{ns}_{k}"][s])
            (gx,) = torch.autograd.grad(ext, local, cot)
            out[f"halo_{ns}_{k}_ext"] = ext.detach().numpy()
            out[f"halo_{ns}_{k}_grad"] = gx.numpy()
        for name, (hin, hout, w_in, w_out) in inp["resize_cases"].items():
            for dt in (torch.float32, torch.bfloat16):
                xs = torch.from_numpy(inp[f"resize_{name}"]).to(dt)
                got = interp_align_corners(xs[:, grid.rows(hin)], (hout, w_out), grid)
                out[f"resize_{ns}_{name}_{dt}"] = _np(got)
        for h in inp["pool_heights"]:
            for dt in (torch.float32, torch.bfloat16):
                xs = torch.from_numpy(inp[f"pool_{h}"]).to(dt)
                out[f"pool_{ns}_{h}_{dt}"] = _np(pool2x(xs[:, grid.rows(h)], grid))
    _train_step(inp, out, make_mesh(2, 2), "train_22")


def _count_spatial(stream):
    """Count the calls of the spatial entries (the CPU runs their plain
    versions, which count no launch)."""
    calls = {"conv_gru_spatial": 0, "motion_spatial": 0}

    def counted(fn, key):
        def wrap(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrap

    stream.fused_conv_gru_spatial = counted(stream.fused_conv_gru_spatial, "conv_gru_spatial")
    stream.fused_motion_spatial = counted(stream.fused_motion_spatial, "motion_spatial")
    return calls


def _entries(inp, out, grid):
    """Each spatial entry on this rank's rows (fp32 and bf16): the output
    and, for a seeded cotangent, the gradients of its module's parameters
    (summed over the ranks) and of its inputs (local rows)."""
    import torch

    from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
    from raft_stereo_tpu_torch.ops import stream
    rows = grid.rows(inp["gru_h"].shape[1])
    for kind, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for head in (False, True):
            tag = f"{'gru_head' if head else 'gru'}_{kind}"
            gru = ConvGRU(*inp["gru_dims"])
            gru.load_state_dict(inp["gru_sd"])
            fh = FlowHead(inp["gru_dims"][0], inp["head_nh"], 2)
            fh.load_state_dict(inp["head_sd"])
            h = torch.from_numpy(inp["gru_h"][:, rows]).to(dt).requires_grad_(True)
            xs = [torch.from_numpy(x[:, rows]).to(dt).requires_grad_(True)
                  for x in inp["gru_xs"]]
            ctx = [torch.from_numpy(c[:, rows]).to(dt).requires_grad_(True)
                   for c in inp["gru_ctx"]]
            czrq = stream.spatial_prepare_gru_context(grid, gru, ctx, dt)
            wts = stream.gru_weights(gru, dt)
            if head:
                h2, dx = stream.fused_gru_head_spatial(grid, wts, stream.head_weights(fh, dt),
                                                       h, czrq, *xs)
                loss = ((h2.float() * torch.from_numpy(inp["cot_h"][:, rows])).sum()
                        + (dx * torch.from_numpy(inp["cot_dx"][:, rows])).sum())
                out[f"{tag}_dx"] = _np(dx)
            else:
                h2, _ = stream.fused_conv_gru_spatial(grid, wts, h, czrq, *xs)
                loss = (h2.float() * torch.from_numpy(inp["cot_h"][:, rows])).sum()
            loss.backward()
            out[f"{tag}_h"] = _np(h2)
            params = {**{f"gru.{n}": g for n, g in _grads(gru).items()},
                      **({f"head.{n}": g for n, g in _grads(fh).items()} if head else {})}
            grid.all_reduce_sum_list_(list(params.values()))
            out[f"{tag}_pgrads"] = {n: _np(g) for n, g in params.items()}
            out[f"{tag}_igrads"] = {"h": _np(h.grad), **{f"x{i}": _np(x.grad)
                                                         for i, x in enumerate(xs)},
                                    **{f"c{i}": _np(c.grad) for i, c in enumerate(ctx)}}
        enc = BasicMotionEncoder(inp["cor_planes"])
        enc.load_state_dict(inp["motion_sd"])
        flow = torch.from_numpy(inp["motion_flow"][:, rows]).to(dt).requires_grad_(True)
        corr = torch.from_numpy(inp["motion_corr"][:, rows]).to(dt).requires_grad_(True)
        got = stream.fused_motion_spatial(grid, stream.motion_weights(enc, dt), flow, corr)
        (got.float() * torch.from_numpy(inp["cot_motion"][:, rows])).sum().backward()
        grads = _grads(enc)
        grid.all_reduce_sum_list_(list(grads.values()))
        out[f"motion_{kind}"] = _np(got)
        out[f"motion_{kind}_pgrads"] = {n: _np(g) for n, g in grads.items()}
        out[f"motion_{kind}_igrads"] = {"corr": _np(corr.grad)}


def unsharded_entries(inp) -> dict:
    """The port's unsharded entries on the whole inputs, with the same
    cotangents: what the spatial entries' gathered rows must equal."""
    import torch

    from raft_stereo_tpu_torch.models.update import BasicMotionEncoder, ConvGRU, FlowHead
    from raft_stereo_tpu_torch.ops import stream
    out = {}
    for kind, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        t = lambda a: torch.from_numpy(a).to(dt).requires_grad_(True)  # noqa: E731
        for head in (False, True):
            tag = f"{'gru_head' if head else 'gru'}_{kind}"
            gru = ConvGRU(*inp["gru_dims"])
            gru.load_state_dict(inp["gru_sd"])
            fh = FlowHead(inp["gru_dims"][0], inp["head_nh"], 2)
            fh.load_state_dict(inp["head_sd"])
            h, xs, ctx = t(inp["gru_h"]), [t(x) for x in inp["gru_xs"]], \
                [t(c) for c in inp["gru_ctx"]]
            h2, dx = stream.fused_conv_gru(
                stream.gru_weights(gru, dt), h, stream.prepare_gru_context(gru, ctx, dt), *xs,
                head=stream.head_weights(fh, dt) if head else None)
            loss = (h2.float() * torch.from_numpy(inp["cot_h"])).sum()
            if head:
                loss = loss + (dx * torch.from_numpy(inp["cot_dx"])).sum()
                out[f"{tag}_dx"] = _np(dx)
            loss.backward()
            out[f"{tag}_h"] = _np(h2)
            out[f"{tag}_pgrads"] = {**{f"gru.{n}": _np(q.grad) for n, q in
                                       gru.named_parameters() if q.grad is not None},
                                    **({f"head.{n}": _np(q.grad) for n, q in
                                        fh.named_parameters() if q.grad is not None}
                                       if head else {})}
            out[f"{tag}_igrads"] = {"h": _np(h.grad), **{f"x{i}": _np(x.grad) for i, x in
                                                         enumerate(xs)},
                                    **{f"c{i}": _np(c.grad) for i, c in enumerate(ctx)}}
        enc = BasicMotionEncoder(inp["cor_planes"])
        enc.load_state_dict(inp["motion_sd"])
        flow, corr = t(inp["motion_flow"]), t(inp["motion_corr"])
        got = stream.fused_motion(stream.motion_weights(enc, dt), flow, corr)
        (got.float() * torch.from_numpy(inp["cot_motion"])).sum().backward()
        out[f"motion_{kind}"] = _np(got)
        out[f"motion_{kind}_pgrads"] = {n: _np(q.grad) for n, q in enc.named_parameters()}
        out[f"motion_{kind}_igrads"] = {"corr": _np(corr.grad)}
    return out


def _model(inp, key):
    import torch

    from raft_stereo_tpu_torch import RAFTStereoConfig
    from raft_stereo_tpu_torch.models import RAFTStereo
    model = RAFTStereo(RAFTStereoConfig(**inp[f"{key}_cfg"]))
    model.load_state_dict(inp[f"{key}_sd"])
    return model.to(torch.device("cpu"))


def _eval(inp, out, grid):
    """The sharded test-mode forward, gathered: fp32, and bf16 with the
    spatial entries engaged (their calls counted)."""
    import torch

    from raft_stereo_tpu_torch.engine.steps import make_eval_step
    from raft_stereo_tpu_torch.ops import stream
    calls = _count_spatial(stream)
    for key in ("eval_fp32", "eval_bf16"):
        model = _model(inp, key).eval()
        images = [torch.from_numpy(inp[f"{key}_{i}"]) for i in ("image1", "image2")]
        before = dict(calls)
        _, up = make_eval_step(model, inp["eval_iters"], grid)(*images)
        out[key] = _np(up)
        out[f"{key}_calls"] = {k: calls[k] - before[k] for k in calls}


def _train_step(inp, out, grid, tag):
    """One train step of the port's TrainStep under ``grid`` on this rank's
    part of the global batch: the host metrics, the parameters after the
    step and the (summed, clipped) gradients it took."""
    import torch

    from raft_stereo_tpu_torch.engine.optimizer import make_optimizer
    from raft_stereo_tpu_torch.engine.steps import make_train_step
    from raft_stereo_tpu_torch.parallel import shard_batch
    model = _model(inp, "train").train()
    opt = make_optimizer(model, *inp["train_opt"], skip_nonfinite=3)
    step = make_train_step(model, opt, inp["train_iters"], grid=grid)
    batch = shard_batch({k: torch.from_numpy(v) for k, v in train_batch().items()}, grid)
    host = step(batch)
    out[tag] = {"host": host,
                "params": {n: _np(p) for n, p in model.named_parameters()},
                "grads": {n: _np(p.grad) for n, p in model.named_parameters()
                          if p.grad is not None}}


def scenario_ns2(inp, out):
    """A 2-rank world, one space row: the spatial entries and the sharded
    evaluation."""
    from raft_stereo_tpu_torch.parallel import make_mesh
    space = make_mesh(1, 2)
    _entries(inp, out, space)
    if space.rank == 0:
        out["unsharded"] = unsharded_entries(inp)
    _eval(inp, out, space)


def scenario_train2(inp, out):
    """A 2-rank world: one data-parallel (2, 1) and one height-sharded
    (1, 2) train step."""
    from raft_stereo_tpu_torch.parallel import make_mesh
    _train_step(inp, out, make_mesh(2, 1), "train_data")
    _train_step(inp, out, make_mesh(1, 2), "train_space")


SCENARIOS = {"halo": scenario_halo, "ns2": scenario_ns2, "train2": scenario_train2}


def main(spec_path: str) -> None:
    import torch

    from raft_stereo_tpu_torch.parallel import maybe_distributed_init
    torch.set_num_threads(2)
    spec = json.loads(Path(spec_path).read_text())
    assert maybe_distributed_init()
    import torch.distributed as dist
    inp = torch.load(Path(spec["in"]) / "inputs.pt", weights_only=False)
    out = {}
    SCENARIOS[spec["scenario"]](inp, out)
    torch.save(out, Path(spec["out"]) / f"rank{dist.get_rank()}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main(sys.argv[1])
