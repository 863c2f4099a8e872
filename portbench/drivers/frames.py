"""Frames back to back through the port's eager entry, ``demo.infer_pair``.

The traffic's parameters: ``height`` x ``width`` pairs, a pool of ``pool``
seeded pairs made on the card and kept there as float32 (1, H, W, 3), as
the port's bench keeps its pair; ``warmup_frames`` frames before the
window. Each frame is dispatched before the last one's disparity is copied
to the host, on a side stream behind that frame's event, into pinned
memory, so the host queues the next frame while the card runs this one.
A frame counts when its disparity is on the host; the window runs from the
first dispatch to the last frame's copy, and no frame is dispatched after
``seconds``.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Runner:
    def __init__(self, ctx):
        from raft_stereo_tpu_torch.demo import infer_pair
        self.ctx = ctx
        self.infer = infer_pair
        tr = ctx.traffic
        self.pool = ctx.pairs(int(tr["pool"]), int(tr["height"]), int(tr["width"]))
        self.inputs = [(l.float()[None], r.float()[None]) for l, r in self.pool]
        self.order = ctx.order(len(self.pool), 1 << 16)
        self.cuda = ctx.device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(ctx.device)
            self.host = [torch.empty((int(tr["height"]), int(tr["width"])), pin_memory=True)
                         for _ in range(2)]
        self._loop(warmup=int(tr["warmup_frames"]))

    def _dispatch(self, n: int):
        left, right = self.inputs[self.order[n]]
        out = self.infer(self.ctx.model, left, right, iters=self.ctx.iters)
        if not self.cuda:
            return out, None
        done = torch.cuda.Event()
        done.record()
        return out, done

    def _fetch(self, n: int, out, done) -> np.ndarray:
        """The frame's disparity on the host (waits for that frame only)."""
        if not self.cuda:
            return out.numpy()
        host = self.host[n % 2]
        with torch.profiler.record_function("portbench.copy_out"), \
                torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(done)
            out.record_stream(self.copy_stream)
            host.copy_(out, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.copy_stream)
        copied.synchronize()
        return host.numpy()

    def _loop(self, warmup: int = 0, seconds: float = 0.0) -> dict:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n, pending, t_last = 0, None, t0
        while True:
            more = n < warmup if warmup else time.perf_counter() < deadline
            nxt = (n, *self._dispatch(n)) if more else None
            if pending is not None:
                k, out, done = pending
                host = self._fetch(k, out, done)
                t_last = time.perf_counter()
                if not warmup:
                    self.ctx.sample.offer(int(self.order[k]), host.copy)
            if nxt is None:
                break
            pending = nxt
            n += 1
        return {"frames": n, "attempted": n, "failed": 0, "wall_s": t_last - t0,
                "latencies_ms": None, "pool": self.pool}

    def window(self, seconds: float) -> dict:
        with self.ctx.profile.window():
            return self._loop(seconds=seconds)

    def records(self) -> dict:
        return {}

    def close(self) -> None:
        self.inputs = None
