#!/usr/bin/env python3
"""Which op makes a served row differ between batch widths.

    python3 scripts/batch_width_ops.py

The default model of chip_smoke.py (seeded, flow head tempered), bf16,
reg_cuda, on the card, at 100x230 (padded to 128x256) and at KITTI
375x1242 (384x1248): four pairs prepared one row at a time (as the
session's batched prepare does), then the advance (2 iterations) and the
epilogue at B=1 on the first row and at B=4 on the stacked rows, every
torch.matmul / einsum / bmm / conv2d / interpolate call recorded with its
first row's input and output. Prints one JSON line a size: whether the
advance's carry and the epilogue's flow of row 0 agree bit for bit, and the
first call whose row-0 inputs agree and whose row-0 outputs differ (op,
shapes, dtype, max |difference|). The kernels' own launches are not
recorded (they are pinned row-independent elsewhere). Needs a CUDA card.
"""
import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
from raft_stereo_tpu_torch.models.raft_stereo import (raft_stereo_epilogue, raft_stereo_prepare,
                                                      raft_stereo_segment_carry,
                                                      stack_refinement_states,
                                                      take_refinement_rows)
from raft_stereo_tpu_torch.ops.padder import InputPadder

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
LOG = []


def row0(x, b):
    if not isinstance(x, torch.Tensor):
        return None
    flat = x.detach().reshape(-1)
    return flat[: flat.numel() // b] if flat.numel() % b == 0 else flat


def wrap(mod, name):
    real = getattr(mod, name)

    def f(*a, **k):
        out = real(*a, **k)
        LOG.append((name, [t for t in a if isinstance(t, torch.Tensor)], out))
        return out
    setattr(mod, name, f)
    return real


reals = [(torch, "matmul", wrap(torch, "matmul")), (torch, "einsum", wrap(torch, "einsum")),
         (torch, "bmm", wrap(torch, "bmm")), (F, "conv2d", wrap(F, "conv2d")),
         (F, "interpolate", wrap(F, "interpolate"))]


def digest(t, b):
    r = row0(t, b)
    return None if r is None else hashlib.sha1(r.contiguous().view(torch.uint8).cpu().numpy()
                                                .tobytes()).hexdigest()


def run(fn, b):
    LOG.clear()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    rec = [(n, [digest(t, b) for t in ins], digest(o, b), tuple(o.shape), o)
           for n, ins, o in LOG]
    return out, rec


def first_diff(r1, r4):
    for i, (a, c) in enumerate(zip(r1, r4)):
        if a[1] == c[1] and a[2] != c[2]:
            o1, o4 = a[4], c[4]
            d = float((row0(o1, 1).float() - row0(o4, 4).float()).abs().max())
            return {"call": i, "op": a[0], "shape_b1": a[3], "shape_b4": c[3],
                    "dtype": str(o1.dtype), "max_abs_diff": d}
    return None


model = cs.seeded_model("cuda")
rng = np.random.default_rng(3)
for (h, w) in ((100, 230), cs.KITTI):
    pairs = [tuple(rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32) for _ in range(2))
             for _ in range(4)]
    padder = InputPadder((1, h, w, 3), divis_by=32, bucket=32)
    states = []
    with torch.no_grad():
        for left, right in pairs:
            lp, rp = padder.pad_np(left, right)
            states.append(raft_stereo_prepare(model, torch.from_numpy(lp).cuda(),
                                              torch.from_numpy(rp).cuda()))
    s4 = stack_refinement_states(states)
    s1 = states[0]
    (a1, _), r1 = run(lambda: raft_stereo_segment_carry(model, s1, iters=2), 1)
    (a4, _), r4 = run(lambda: raft_stereo_segment_carry(model, s4, iters=2), 4)
    same_adv = {k: bool(torch.equal(take_refinement_rows(a4, [0])[k], a1[k]))
                for k in ("coords1",)}
    same_net = [bool(torch.equal(x[:1], y)) for x, y in zip(a4["net"], a1["net"])]
    e1, q1 = run(lambda: raft_stereo_epilogue(model, a1), 1)
    e4, q4 = run(lambda: raft_stereo_epilogue(model, take_refinement_rows(a4, [0, 0, 0, 0])), 4)
    print(json.dumps({"hw": [h, w], "padded": list(padder.padded_shape),
                      "advance_coords_same": same_adv, "advance_net_same": same_net,
                      "advance_first_diff": first_diff(r1, r4), "advance_calls": len(r1),
                      "epilogue_up_same": bool(torch.equal(e4[1][:1], e1[1])),
                      "epilogue_first_diff": first_diff(q1, q4),
                      "epilogue_ops": [(r[0], r[3]) for r in q1]}))
for mod, name, real in reals:
    setattr(mod, name, real)
