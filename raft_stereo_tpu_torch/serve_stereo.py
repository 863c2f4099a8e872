"""Serving CLI of the port: ``python -m raft_stereo_tpu_torch.serve_stereo``.

The root ``serve_stereo.py``'s flags, defaults and output lines, on the
port's ``InferenceSession`` + ``StereoService`` (CUDA-graph programs on the
card, the circuit breaker, the startup parity canary, per-request deadlines
with anytime degradation, continuous batching with ``--max_batch > 1``).
It globs left/right pairs (``-l``/``-r``), streams each through the bounded
queue and prints one JSON line per response, then the final ``/healthz``
document; with ``--http_port`` it serves ``POST /v1/stereo``, ``GET
/healthz`` and ``GET /metrics`` until SIGTERM, which drains. Runs on CUDA
unless ``--device cpu``.

Model construction differs from the root CLI: ``--restore_ckpt`` takes a
reference ``.pth`` or one of the port's own ``.pt`` training bundles
(``engine/checkpoint.load_params``; the JAX package's ``.msgpack`` bundles
are its own and do not load here); no checkpoint means random weights from
seed 0 (``init_raft_stereo(cfg, seed=0)``). ``--mesh_data N`` serves one
session over a data mesh of N devices (``cuda:0 .. cuda:N-1``; with
``--device cpu`` the CPU N times): batch buckets round up to multiples of N,
every batched program runs as N shards, and ``/healthz`` carries the mesh
block and a ``chips`` block under ``capacity``. Video
streams (``X-Raft-Session``, ``--stream_sessions``, ``--stream_ttl_ms``,
``--converge_tol``) and the response cache (``--cache_bytes``, on at 256 MiB
as in the root CLI; ``--cache_near_tol``) behave as the root CLI's;
``RAFT_CACHE_DIR`` and ``RAFT_CACHE_TTL_MS`` come from the environment,
which is how the fleet (``python -m raft_stereo_tpu_torch.fleet_stereo``)
hands its ``--cache_dir`` to each instance.

Examples::

    # a tiny random model on the CPU, over HTTP
    python -m raft_stereo_tpu_torch.serve_stereo --device cpu --http_port 8080 \\
        --valid_iters 4 --segments 2 --n_gru_layers 1 --hidden_dims 32 32 32 \\
        --corr_levels 2 --corr_radius 2 --no_canary --warmup 40x60 --watchdog_ms 0

    # the default model on the card, continuous batching
    python -m raft_stereo_tpu_torch.serve_stereo --restore_ckpt raftstereo.pth \\
        --corr_implementation reg_cuda --http_port 8080 --max_batch 4 \\
        --warmup 375x1242

    # the same over two cards (a data mesh): buckets 2 and 4, two shards each
    python -m raft_stereo_tpu_torch.serve_stereo --restore_ckpt raftstereo.pth \\
        --corr_implementation reg_cuda --http_port 8080 --max_batch 4 \\
        --mesh_data 2 --warmup 375x1242
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import threading
from pathlib import Path


#: The readiness handshake's key, the embedded frontend's port knob.
HANDSHAKE_KEY = "RAFT_HTTP_PORT"


def build_parser() -> argparse.ArgumentParser:
    from raft_stereo_tpu_torch.config import add_model_args

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--restore_ckpt', default=None,
                        help="checkpoint (.pth reference weights or a .pt "
                        "training bundle); omitted = random init (smoke runs)")
    parser.add_argument('-l', '--left_imgs', default=None,
                        help="glob for left frames (batch mode; not "
                        "needed with --http_port)")
    parser.add_argument('-r', '--right_imgs', default=None,
                        help="glob for right frames (batch mode)")
    parser.add_argument('--output_directory', default=None,
                        help="save disparity .npy files here (optional)")
    parser.add_argument('--valid_iters', type=int, default=32,
                        help='refinement iterations for an undegraded pass')
    # Serving knobs
    parser.add_argument('--bucket', type=int, default=64,
                        help="pad request shapes to multiples of this "
                        "(multiple of 32) so mixed sizes share compiles")
    parser.add_argument('--segments', type=int, default=4,
                        help="host-visible scan segments for deadline "
                        "requests (must divide valid_iters)")
    parser.add_argument('--deadline_ms', type=float, default=None,
                        help="per-request deadline; omitted = no degradation")
    parser.add_argument('--max_queue', type=int, default=8,
                        help="bounded queue depth (full -> explicit reject)")
    parser.add_argument('--workers', type=int, default=1,
                        help="worker threads draining the queue "
                        "(sequential mode; with --max_batch > 1 one "
                        "scheduler thread replaces the pool and this only "
                        "caps the CLI's in-flight requests)")
    parser.add_argument('--max_batch', type=int, default=1,
                        help="continuous batching: up to this many "
                        "requests share one device batch, joining at tick "
                        "boundaries and exiting at segment boundaries "
                        "(1 = sequential serving)")
    parser.add_argument('--tick_ms', type=float, default=None,
                        help="scheduler idle-poll interval (batched mode; "
                        "default RAFT_SCHED_TICK_MS or 2 ms)")
    # graftpod: pod-scale serving (DESIGN.md r21)
    parser.add_argument('--mesh_data', type=int, default=None,
                        help="shard the device batch over this many chips "
                        "(data mesh): one ingress drives N devices, batch "
                        "buckets round up to multiples of N, per-chip "
                        "occupancy/saturation surfaces on /healthz "
                        "(1 = single device; with --device cpu the CPU is "
                        "listed N times)")
    parser.add_argument('--max_pixels', type=int, default=8 << 20,
                        help="admission cap on per-image area")
    # graftlane (r24) + r19 pack opt-ins: CLI sugar over the env kill
    # switches. setdefault semantics — an EXPLICIT RAFT_*_PACK8 env value
    # (including 0) wins over the flag, so an operator's kill-switch
    # export is never silently re-armed by a stale launch script.
    parser.add_argument('--pack8', action='store_true',
                        help="arm the int8 quad-packed correlation "
                        "containers (RAFT_CORR_PACK8=1 unless that env "
                        "var is already set)")
    parser.add_argument('--lane_pack8', action='store_true',
                        help="arm the int8 packed context lanes for "
                        "per-iteration feature/context traffic "
                        "(RAFT_LANE_PACK8=1 unless that env var is "
                        "already set)")
    parser.add_argument('--warmup', default=None,
                        help="comma-separated HxW image shapes to "
                        "pre-compile, e.g. '544x960,736x1280'")
    parser.add_argument('--no_canary', action='store_true',
                        help="skip the startup parity canary (the card's "
                        "program against the plain program on the CPU)")
    parser.add_argument('--no_heal', action='store_true',
                        help="disable the recovery plane (RAFT_HEAL=0 "
                        "equivalent): breaker trips, chip quarantines "
                        "and restart-budget exhaustion stay one-way")
    parser.add_argument('--no_half_res', action='store_true',
                        help="never degrade to half resolution")
    parser.add_argument('--status_json', default=None,
                        help="also write the final /healthz status here")
    parser.add_argument('--metrics_prom', default=None,
                        help="write the final Prometheus /metrics text "
                        "here (the same registry /healthz derives from; "
                        "RAFT_TRACE=<path.jsonl> additionally streams "
                        "per-request span timelines, RAFT_PROFILE_DIR "
                        "arms on-demand torch.profiler windows)")
    parser.add_argument('--ledger_out', default=None,
                        help="write the device ledger dump here (inspect "
                        "with `python -m raft_stereo_tpu_torch.obs.ledger "
                        "report`): per-program flops, capture seconds, graph "
                        "pool and peak device bytes, MFU attribution")
    parser.add_argument('--slo_ms', type=float, default=None,
                        help="latency SLO: a served request slower than "
                        "this (or any breaker trip / missed deadline / "
                        "non-finite output) persists a bounded flight "
                        "record to RAFT_FLIGHT_DIR")
    # graftguard: supervision + drain (DESIGN.md r13). The CLI defaults
    # the watchdog ON (the library default is off so test rigs with fake
    # clocks never race a real-time monitor).
    parser.add_argument('--watchdog_ms', type=float, default=10_000.0,
                        help="hang-watchdog deadline floor: a device "
                        "invocation older than max(EMA*4, this) bounces "
                        "the scheduler generation and re-admits its rows "
                        "(0 disables; default 10s)")
    parser.add_argument('--retry_budget', type=int, default=None,
                        help="bounded re-admissions per request for "
                        "transient failures (uploader death, generation "
                        "bounce, a first non-finite output); responses "
                        "carry 'retries: k' (default RAFT_RETRY_BUDGET "
                        "or 2)")
    parser.add_argument('--drain_grace_ms', type=float, default=None,
                        help="SIGTERM/SIGINT graceful-drain hard "
                        "deadline: admitted requests run to their "
                        "segment-boundary exits within this window, "
                        "then the rest resolve service_stopped (default "
                        "RAFT_DRAIN_GRACE_MS or 10s)")
    # Video streams (serve/stream.py).
    parser.add_argument('--stream_sessions', type=int, default=None,
                        help="global bound on live stream sessions "
                        "(X-Raft-Session warm-start table; default "
                        "RAFT_STREAM_SESSIONS or 128)")
    parser.add_argument('--stream_ttl_ms', type=float, default=None,
                        help="idle stream-session expiry (default "
                        "RAFT_STREAM_TTL_MS or 60s)")
    parser.add_argument('--converge_tol', type=float, default=None,
                        help="convergence early-exit tolerance stamped "
                        "on warm frames: segment-mean per-iteration "
                        "|delta_x| at 1/8 res, px (0 disables; default "
                        "RAFT_CONVERGE_TOL or 0.01)")
    # The response cache (serve/cache.py). The CLI defaults it ON (the
    # library default is off so test rigs and embedders opt in, as with
    # the watchdog).
    parser.add_argument('--cache_bytes', type=int, default=None,
                        help="host-RAM budget for the two-tier response "
                        "cache: exact hits (sha256 of the padded pair + "
                        "program fingerprint + tenant) serve the stored "
                        "response bit-identically at zero device "
                        "seconds, labeled cache:exact (0 disables; "
                        "default RAFT_CACHE_BYTES or 256 MiB)")
    parser.add_argument('--cache_near_tol', type=float, default=None,
                        help="near-duplicate tier threshold (mean "
                        "block-signature difference, gray levels): a "
                        "close-enough stored scene seeds coords1 "
                        "through prepare_warm and the response is "
                        "labeled warm:cache:<iters> (0 disables; "
                        "default RAFT_CACHE_NEAR_TOL or 0)")
    # graftwire: network ingress (DESIGN.md r14)
    parser.add_argument('--http_port', type=int, default=None,
                        help="serve POST /v1/stereo + GET /healthz "
                        "+ GET /metrics over HTTP/1.1 on this port "
                        "instead of running the glob batch driver "
                        "(0 = ephemeral; omit the flag entirely for "
                        "batch mode — RAFT_HTTP_PORT applies to "
                        "embedded HttpConfig use, not this flag)")
    parser.add_argument('--http_host', default="127.0.0.1",
                        help="ingress bind address (default loopback; "
                        "widen to 0.0.0.0 deliberately)")
    parser.add_argument('--tenant_rate', default=None,
                        help="per-tenant admission quota 'rate[:burst]' "
                        "requests/s keyed by X-Raft-Tenant (default "
                        "RAFT_TENANT_RATE or unlimited)")
    parser.add_argument('--decode_workers', type=int, default=2,
                        help="decode-offload pool width: HTTP mode "
                        "decodes request images here instead of on "
                        "acceptor threads; batch mode prefetches file "
                        "decode ahead of admission (decode caps the "
                        "host path)")
    # graftfleet: supervisor readiness handshake (DESIGN.md r20)
    parser.add_argument('--device', default="cuda",
                        help="torch device to serve on (default cuda; cpu runs "
                        "the kernels' plain torch versions, programs eager)")
    parser.add_argument('--ready_fd', type=int, default=None,
                        help="inherited file descriptor to write the "
                        "RAFT_HTTP_PORT=<n> readiness handshake to "
                        "(then closed) — lets a fleet supervisor await "
                        "readiness via a pipe instead of parsing "
                        "stdout; the same line always goes to stdout "
                        "too (HTTP mode only)")
    add_model_args(parser)
    return parser


def _cli_cache_bytes(args) -> int:
    """The CLI's response-cache budget, ON at 256 MiB: the --cache_bytes
    flag (0 disables) > RAFT_CACHE_BYTES (an explicit 0 there disables
    too) > 256 MiB. The library's ServiceConfig default stays off."""
    import os

    from raft_stereo_tpu_torch.serve.cache import DEFAULT_CACHE_BYTES, resolve_cache_bytes
    if args.cache_bytes is not None:
        return args.cache_bytes
    if os.environ.get("RAFT_CACHE_BYTES", "").strip():
        return resolve_cache_bytes(None)
    return DEFAULT_CACHE_BYTES


def _parse_warmup(spec):
    if not spec:
        return ()
    shapes = []
    for part in spec.split(','):
        h, _, w = part.strip().partition('x')
        shapes.append((int(h), int(w)))
    return tuple(shapes)


def iter_decoded_pairs(pairs, decode_one, workers: int = 2,
                       lookahead=None):
    """Decode offload for the closed-loop batch driver: yield
    ``(left_path, right_path, future)`` in submission order with file
    decode running in a small thread pool up to ``lookahead`` pairs
    ahead of admission.

    Without it the submit loop pays each PNG decode INLINE between
    submissions — serializing host decode
    ahead of admission exactly like an inline upload path serializes
    transfers. Ordering is preserved (a deque of futures, consumed
    FIFO), so outputs are byte-identical to the sequential decode path
    (test-pinned in tests/test_http.py); the bounded lookahead keeps
    peak memory at ``lookahead`` decoded pairs regardless of glob size.
    A consumer that stops consuming (drain) just cancels what it skips —
    the pool dies with the generator."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    lookahead = max(1, lookahead if lookahead is not None
                    else 2 * max(1, workers))
    pool = ThreadPoolExecutor(max_workers=max(1, workers),
                              thread_name_prefix="stereo-cli-decode")
    queue = deque()
    it = iter(pairs)

    def pump() -> None:
        while len(queue) < lookahead:
            try:
                f1, f2 = next(it)
            except StopIteration:
                return
            queue.append((f1, f2, pool.submit(
                lambda a=f1, b=f2: (decode_one(a), decode_one(b)))))

    try:
        pump()
        while queue:
            f1, f2, fut = queue.popleft()
            yield f1, f2, fut
            pump()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def serve(args) -> int:
    # Mode validation needs only args — run it before any model load or
    # warmup compile so a missing-glob invocation fails in milliseconds,
    # not after a checkpoint read and a warm-up (argparse can't express
    # "required unless --http_port", so it lives here).
    if args.http_port is None and (not args.left_imgs
                                   or not args.right_imgs):
        raise SystemExit("batch mode needs -l/--left_imgs and "
                         "-r/--right_imgs (or serve the network with "
                         "--http_port)")
    if args.mesh_data is not None and args.mesh_data < 1:
        raise SystemExit(f"--mesh_data must be >= 1, got {args.mesh_data}")

    # Pack opt-ins must land before ANY program trace (the switches are
    # read at trace time); explicit env always wins over the flag.
    if args.pack8 or args.lane_pack8:
        import os
        if args.pack8:
            os.environ.setdefault("RAFT_CORR_PACK8", "1")
        if args.lane_pack8:
            os.environ.setdefault("RAFT_LANE_PACK8", "1")

    import numpy as np

    from raft_stereo_tpu_torch.config import (RAFTStereoConfig,
                                              with_eval_precision)
    from raft_stereo_tpu_torch.data.frame_utils import read_image_rgb
    from raft_stereo_tpu_torch.models import RAFTStereo, init_raft_stereo
    from raft_stereo_tpu_torch.serve import (AdmissionConfig, InferenceSession,
                                             ServiceConfig, SessionConfig,
                                             StereoService)
    from raft_stereo_tpu_torch.engine.checkpoint import load_params

    cfg = RAFTStereoConfig.from_namespace(args)
    if args.restore_ckpt is not None:
        model = RAFTStereo(cfg)
        load_params(args.restore_ckpt, model)
    else:
        logging.warning("no --restore_ckpt: serving RANDOM weights "
                        "(wiring smoke only)")
        model = init_raft_stereo(cfg, seed=0, device="cpu")
    cfg = with_eval_precision(cfg)  # the one shared inference bf16 policy

    session = InferenceSession(
        model, cfg,
        SessionConfig(
            valid_iters=args.valid_iters,
            segments=args.segments,
            bucket=args.bucket,
            warmup_shapes=_parse_warmup(args.warmup),
            warmup_segmented=args.deadline_ms is not None,
            canary=not args.no_canary,
            allow_half_res=not args.no_half_res,
            max_batch=args.max_batch,
            mesh_data=args.mesh_data,
            heal=False if args.no_heal else None,
            admission=AdmissionConfig(max_pixels=args.max_pixels)),
        device=args.device)
    service = StereoService(session, ServiceConfig(
        max_queue=args.max_queue, workers=args.workers,
        tick_ms=args.tick_ms, slo_ms=args.slo_ms,
        watchdog_ms=args.watchdog_ms, retry_budget=args.retry_budget,
        drain_grace_ms=args.drain_grace_ms,
        stream_sessions=args.stream_sessions,
        stream_ttl_ms=args.stream_ttl_ms,
        converge_tol=args.converge_tol,
        cache_bytes=_cli_cache_bytes(args),
        cache_near_tol=args.cache_near_tol))

    # Graceful drain on SIGTERM/SIGINT: the handler
    # only sets a flag (async-signal-safe); the submit loop below flips
    # the service into draining at the next response boundary — admitted
    # requests run to their segment-boundary exits with honest labels,
    # late submits are rejected ``service_draining``, telemetry flushes,
    # and a clean preemption exits 0. A SECOND signal restores the
    # default disposition and redelivers itself — the operator's
    # escalation path when the graceful drain is wedged.
    import os
    import signal
    stop_requested = threading.Event()

    def _request_drain(signum, frame):  # noqa: ARG001 — signal signature
        if stop_requested.is_set():
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        stop_requested.set()

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_drain)
        except ValueError:  # non-main thread (embedded use): skip
            pass

    from raft_stereo_tpu_torch.serve.supervise import resolve_drain_grace_ms
    grace_s = resolve_drain_grace_ms(args.drain_grace_ms) / 1e3

    def write_artifacts() -> None:
        status = service.status()
        print(json.dumps(status, indent=2, default=str))
        if args.status_json:
            Path(args.status_json).write_text(
                json.dumps(status, indent=2, default=str))
        if args.metrics_prom:
            Path(args.metrics_prom).write_text(service.metrics_text())
        if args.ledger_out:
            from raft_stereo_tpu_torch.obs.ledger import save_doc
            save_doc(session.ledger_doc(), args.ledger_out)

    # -- network ingress mode (graftwire, DESIGN.md r14) -------------------
    if args.http_port is not None:
        from raft_stereo_tpu_torch.serve import HttpConfig, HttpFrontend
        service.start()
        frontend = HttpFrontend(service, HttpConfig(
            host=args.http_host, port=args.http_port,
            tenant_rate=args.tenant_rate,
            decode_workers=args.decode_workers)).start()
        print(json.dumps({
            "event": "listening",
            "endpoint": f"http://{frontend.host}:{frontend.port}",
            "routes": ["POST /v1/stereo", "GET /healthz", "GET /metrics"],
        }), flush=True)
        # graftfleet readiness handshake: ONE machine-parseable line on
        # stdout, printed only here — after warmup compiles, after the
        # listener is accepting — so a supervisor that reads it can
        # route traffic immediately.  --ready_fd gets the same line on
        # an inherited pipe (write+close; EOF doubles as a liveness
        # signal), sparing the supervisor a stdout parse.  flush=True
        # everywhere: a block-buffered pipe would hold the handshake
        # hostage until the 4 KiB stdio buffer fills.
        handshake = f"{HANDSHAKE_KEY}={frontend.port}\n"
        print(handshake, end="", flush=True)
        if args.ready_fd is not None:
            try:
                os.write(args.ready_fd, handshake.encode())
                os.close(args.ready_fd)
            except OSError:
                # A supervisor that died between fork and handshake is
                # its problem; the instance serves regardless.
                pass
        try:
            while not stop_requested.wait(0.2):
                # graftheal: the production recovery drive point — the
                # wait loop, NOT the Supervisor's monitor thread
                # (detection and recovery stay on separate triggers; the
                # chaos battery pins the detector's one-way monotonicity
                # mid-storm).  A sweep with nothing in probation is two
                # lock peeks; probes/canaries only run once a probation
                # deadline elapses.  Failure-isolated: a dying sweep
                # must never take the serve loop down with it.
                try:
                    service.heal_sweep()
                except Exception:
                    logging.exception("heal sweep failed")
            # SIGTERM rides the service's drain: the very same state machine
            # in-process callers get — late wire requests are answered
            # 503 service_draining by the still-listening frontend,
            # admitted rows run to their segment-boundary exits within
            # the grace window, THEN the listener stops accepting.
            print(json.dumps({"event": "draining",
                              "reason": "signal received"}), flush=True)
            clean = service.drain(grace_s)
            print(json.dumps({"event": "drained", "clean": clean}),
                  flush=True)
        finally:
            frontend.stop()
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
        write_artifacts()
        return 0

    # -- glob batch-driver mode (globs validated before model load) --------
    left_images = sorted(glob.glob(args.left_imgs, recursive=True))
    right_images = sorted(glob.glob(args.right_imgs, recursive=True))
    if len(left_images) != len(right_images):
        raise SystemExit(
            f"left glob matched {len(left_images)} files but right glob "
            f"matched {len(right_images)} — zip would silently drop the "
            "difference; fix the globs")
    print(f"Found {len(left_images)} pairs.")
    out_dir = Path(args.output_directory) if args.output_directory else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)

    import time
    from concurrent.futures import TimeoutError as FuturesTimeout

    failures = 0
    seq = 0
    draining = False
    # Bounds the consume loop once a drain begins: grace expiry force-
    # stops the service (resolving everything resolvable), and a Future
    # that survives even that (a wedged device call with supervision
    # off) is abandoned honestly rather than hanging the exit path.
    drain_track = {"deadline": None, "stopped": False}

    def begin_drain_once() -> None:
        nonlocal draining
        if not draining:
            draining = True
            print(json.dumps({"event": "draining",
                              "reason": "signal received"}))
            service.begin_drain()

    def consume(fut) -> None:
        nonlocal failures, seq
        # Short-poll instead of a blocking result(): the signal handler
        # only sets a flag, so the drain flip must happen here, on the
        # submit loop's thread, within one poll interval of the signal.
        while True:
            try:
                resp = fut.result(timeout=0.2)
                break
            except FuturesTimeout:
                if not stop_requested.is_set():
                    continue
                begin_drain_once()
                now = time.monotonic()
                if drain_track["deadline"] is None:
                    drain_track["deadline"] = now + grace_s
                elif not drain_track["stopped"] and \
                        now >= drain_track["deadline"]:
                    drain_track["stopped"] = True
                    service.stop()  # force-resolve the still-resolvable
                elif drain_track["stopped"] and \
                        now >= drain_track["deadline"] + 5.0:
                    failures += 1
                    print(json.dumps({
                        "status": "error", "code": "abandoned_at_drain",
                        "message": "Future unresolved past the drain "
                                   "hard deadline (wedged device call "
                                   "with supervision off?)"}))
                    return
        line = {k: v for k, v in resp.items() if k != "disparity"}
        print(json.dumps(line, default=str))
        if resp["status"] != "ok":
            # Draining rejections are the *intended* shutdown contract,
            # not serving failures — they must not flip the exit code.
            if resp.get("code") != "service_draining":
                failures += 1
        elif out_dir is not None:
            # Sequence-prefixed: Middlebury-style globs (*/im0.png) share
            # one stem across every scene, which would silently overwrite.
            stem = f"{seq:05d}_{Path(resp['id']).stem}"
            np.save(out_dir / f"{stem}_disp.npy", resp["disparity"])
        seq += 1

    # In-flight cap for this closed-loop driver: the queue bound normally,
    # but only the device concurrency when requests carry deadlines — a
    # deadline is stamped at submit time, so anything parked behind busy
    # capacity would burn its whole budget queued and be rejected
    # deadline_exceeded_in_queue instead of degrading. With --max_batch
    # the device serves up to max_batch rows concurrently, so the cap must
    # be at least that or the driver itself would starve the batch.
    concurrency = args.max_batch if args.max_batch > 1 else args.workers
    inflight_cap = max(
        1, concurrency if args.deadline_ms is not None
        else max(args.max_queue, args.max_batch))

    service.start()
    try:
        # Drain as we submit: this batch driver respects the service's
        # backpressure by capping its own in-flight requests below the
        # queue bound instead of firing the whole glob at a bounded queue
        # (which would correctly reject most of it with queue_full —
        # the right answer for an open-loop network caller, the wrong
        # one for a closed-loop batch job).
        from collections import deque
        pending = deque()

        def decode_one(path):
            return read_image_rgb(path).astype(np.float32)[None]

        # Decode rides a small thread pool AHEAD of admission
        # (iter_decoded_pairs): the submit loop no longer serializes
        # PNG decode between submissions, and ordering
        # — hence output bytes — is unchanged (FIFO future consumption,
        # pinned in tests/test_http.py).
        pairs = list(zip(left_images, right_images))
        decode_stream = iter_decoded_pairs(
            pairs, decode_one, workers=args.decode_workers)
        drained_from = None
        for i, (f1, f2, decoded) in enumerate(decode_stream):
            if stop_requested.is_set():
                # Stop the decode pump FIRST (closing the generator
                # cancels every queued decode — the pump refills the
                # pool per yield, so cancelling just this future would
                # keep decoding doomed files), then
                # stub-submit the remainder through the drain below.
                begin_drain_once()
                decode_stream.close()
                drained_from = i
                break
            while len(pending) >= inflight_cap:
                consume(pending.popleft())
            try:
                left, right = decoded.result()
            except Exception as e:  # noqa: BLE001 — hostile-file boundary
                # One unreadable/oversized file (e.g. ImageTooLarge from
                # the decode-bomb cap) is one structured failure line,
                # never an aborted run with the rest of the glob
                # unserved.
                failures += 1
                code = getattr(e, "code", "decode_failed")
                print(json.dumps({
                    "id": f1, "status": "rejected", "code": code,
                    "message": f"{type(e).__name__}: {e}"}))
                continue
            request = {"id": f1, "left": left, "right": right}
            if args.deadline_ms is not None:
                request["deadline_ms"] = args.deadline_ms
            pending.append(service.submit(request))
        if drained_from is not None:
            # Submit through the drain WITHOUT waiting for decode: the
            # drain flip above precedes the submits, so rejection is
            # guaranteed — the printed service_draining line still names
            # each file that was NOT served (the wire-level proof), at
            # stub cost instead of a full image decode per doomed
            # request.
            stub = np.zeros((1, 32, 32, 3), dtype=np.float32)
            for f1, _f2 in pairs[drained_from:]:
                pending.append(service.submit(
                    {"id": f1, "left": stub, "right": stub}))
        while pending:
            consume(pending.popleft())
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        if stop_requested.is_set():
            # A drain whose hard deadline already force-stopped work is
            # NOT clean, even though drain() on the now-stopped service
            # quiesces instantly — an orchestrator must not read a
            # timed-out drain as graceful.
            clean = service.drain() and not drain_track["stopped"]
            print(json.dumps({"event": "drained", "clean": clean}))
        else:
            service.stop()

    write_artifacts()
    if failures:
        # Real failures flip the exit code even when a drain signal
        # arrived — an orchestrator must not read a preempted run with
        # genuinely failed requests as clean. Draining rejections are
        # the intended shutdown contract and never count.
        print(f"{failures}/{len(left_images)} requests failed")
        return 1
    # Flight records flushed per-response, final metrics/status written
    # above — a clean run (drained-on-signal included) is exit 0.
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return serve(args)


if __name__ == '__main__':
    raise SystemExit(main())
