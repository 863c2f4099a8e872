"""Closed-loop clients of the port's server, ``StereoService.submit``.

The traffic's parameters: ``clients`` threads, each sending its next
request when its last response returns; a pool of ``pool`` seeded uint8
``height`` x ``width`` pairs on the host; the session's ``max_batch``
(1: the worker path and the one-shot ``full`` program; more: the
continuous-batching scheduler at batch buckets up to it) and ``segments``;
``warmup_requests`` a client before the window. The session warms the
pool's shape at every batch bucket when it is built, and the warm-up
requests pass once through everything else.

Each request is timed from its submit to its response. No request is
submitted after ``seconds``; the window ends with the last response, so
its latencies are those of every request it sent. With a trace the
``RAFT_TRACE`` sink (a file under ``TMPDIR``) and the session's tick deck
give each request's spans and each scheduler tick.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

# How long a request may take past the window's close before it counts as
# never answered.
GRACE_S = 60.0


class Runner:
    def __init__(self, ctx):
        from raft_stereo_tpu_torch.serve import (InferenceSession, ServiceConfig,
                                                 SessionConfig, StereoService)
        self.ctx = ctx
        tr = ctx.traffic
        h, w = int(tr["height"]), int(tr["width"])
        self.clients = int(tr["clients"])
        pool = ctx.pairs(int(tr["pool"]), h, w)
        self.pool = [(l.cpu().numpy(), r.cpu().numpy()) for l, r in pool]
        del pool
        self.order = ctx.order(len(self.pool), 1 << 16)
        self.trace_dir = None
        if ctx.profile.enabled:
            # Read by the session's tracer when it is built.
            self.trace_dir = tempfile.mkdtemp(prefix="portbench-")
            os.environ["RAFT_TRACE"] = os.path.join(self.trace_dir, "requests.jsonl")
        self.session = InferenceSession(ctx.model, ctx.model.cfg, SessionConfig(
            valid_iters=ctx.iters, segments=int(tr["segments"]),
            max_batch=int(tr["max_batch"]), warmup_shapes=((h, w),)), device=ctx.device)
        self.service = StereoService(self.session, ServiceConfig(
            max_queue=max(8, 2 * self.clients))).start()
        self.lock = threading.Lock()
        self._drive("u", count=int(tr["warmup_requests"]))
        self.seq_before = max((t["seq"] for t in self.session.deck.snapshot()), default=-1)

    def _drive(self, tag: str, count: int = 0, seconds: float = 0.0) -> dict:
        """``clients`` closed loops, each for ``count`` requests or, without
        a count, until ``seconds`` have passed."""
        done = []  # (t_submit, t_response, ok)
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def client(k: int) -> None:
            j = 0
            while (j < count) if count else (time.perf_counter() < deadline):
                idx = int(self.order[(j * self.clients + k) % len(self.order)])
                left, right = self.pool[idx]
                t_sub = time.perf_counter()
                fut = self.service.submit({"id": f"{tag}{k}-{j}", "left": left, "right": right})
                try:
                    resp = fut.result(timeout=max(GRACE_S, deadline + GRACE_S - t_sub))
                except FutureTimeout:
                    with self.lock:
                        done.append((t_sub, time.perf_counter(), False))
                    return
                t_resp = time.perf_counter()
                ok = resp.get("status") == "ok" and resp.get("quality") == "full"
                with self.lock:
                    done.append((t_sub, t_resp, ok))
                    if ok and not count:
                        disp = resp["disparity"]
                        self.ctx.sample.offer(idx, lambda: disp)
                j += 1

        threads = [threading.Thread(target=client, args=(k,), name=f"portbench-client-{k}")
                   for k in range(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        n_ok = sum(ok for _, _, ok in done)
        t_last = max((r for _, r, _ in done), default=t0)
        return {"frames": n_ok, "attempted": len(done), "failed": len(done) - n_ok,
                "wall_s": t_last - t0,
                "latencies_ms": [(r - s) * 1e3 for s, r, _ in done]}

    def window(self, seconds: float) -> dict:
        with self.ctx.profile.window():
            out = self._drive("w", seconds=seconds)
        return {**out, "pool": self.pool}

    def records(self) -> dict:
        """With a trace: the window's request timelines and scheduler ticks."""
        if self.trace_dir is None:
            return {}
        ticks = [t for t in self.session.deck.snapshot()
                 if t["seq"] > self.seq_before and t["kind"] == "tick"]
        self.service.stop()
        self.session.tracer.close()
        requests = []
        with open(os.environ["RAFT_TRACE"]) as f:
            for line in f:
                doc = json.loads(line)
                if str(doc.get("request_id", "")).startswith("w"):
                    requests.append(doc)
        return {"requests": requests, "ticks": ticks}

    def close(self) -> None:
        self.service.stop()
        self.service = self.session = None
        if self.trace_dir is not None:
            os.environ.pop("RAFT_TRACE", None)
            shutil.rmtree(self.trace_dir, ignore_errors=True)
