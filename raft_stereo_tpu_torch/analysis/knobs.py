"""The port's registry of environment knobs: which ``RAFT_*`` switches
shape a program, and which steer only the host.

The counterpart of the JAX package's ``analysis/knobs.py``, listing what the
port reads. The serving session (``serve/session.py``) keys every cached
program on the values of :data:`ENV_KNOBS`, and the breaker's ladder
(``serve/guard.py``) turns them off one rung at a time. Stdlib only.
"""

from __future__ import annotations

from typing import Tuple

# Switches whose values shape a program (``config.py``): part of every serving
# cache key, so that a flipped switch (a breaker trip or an operator's export)
# is never served a program built under the old value. The JAX package's
# RAFT_PACKED_L2, RAFT_CORR_TILE, RAFT_STREAM_BATCH and RAFT_BATCH_FUSE_PIXELS
# have no reader in the port and are not listed.
ENV_KNOBS: Tuple[str, ...] = (
    "RAFT_STREAM_TAIL",     # stride-1 tail blocks and finest heads through
                            # the encoder kernels (ops/encoder.py, default on)
    "RAFT_FUSE_GRU1632",    # gru32 and gru16 in one launch (ops/stream.py,
                            # default on)
    "RAFT_FUSED_ENCODERS",  # the encoder kernels (ops/encoder.py, default on)
    "RAFT_FUSE_ITER",       # the resident iteration kernel (ops/resident.py,
                            # default on)
    "RAFT_CORR_PACK8",      # int8 correlation levels (corr/reg_cuda.py,
                            # default off)
    "RAFT_LANE_PACK8",      # int8 context lanes (models/raft_stereo.py,
                            # ops/stream.py, default off)
)

# Serving knobs that change no program: each steers host-side supervision
# (serve/supervise.py, read at construction), so none is in a cache key.
# The JAX package's scheduler, HTTP and batch-bucket knobs come with the
# port's scheduler and frontends.
SERVE_ENV_KNOBS: Tuple[str, ...] = (
    "RAFT_WATCHDOG_MS",     # hang-watchdog deadline floor, ms; 0 = off
    "RAFT_RETRY_BUDGET",    # bounded per-request re-admissions
    "RAFT_DRAIN_GRACE_MS",  # graceful-drain hard deadline, ms
)

# Host knobs: telemetry sinks, telemetry sizing and recovery pacing. No
# program depends on any of them.
HOST_ENV_KNOBS: Tuple[str, ...] = (
    "RAFT_TRACE",           # request-trace JSONL sink (obs/tracing.py)
    "RAFT_PROFILE_DIR",     # torch.profiler window output (obs/profiler.py)
    "RAFT_TRAJECTORY",      # perf-trajectory file (obs/trajectory.py)
    "RAFT_FLIGHT_DIR",      # SLO flight records (obs/flight.py)
    "RAFT_LEDGER",          # program-ledger dump target (obs/ledger.py)
    "RAFT_DECK_TICKS",      # tick-deck ring depth (obs/deck.py)
    "RAFT_CAPACITY_WINDOW_MS",  # saturation window (obs/capacity.py)
    "RAFT_HEAL",            # recovery-plane switch (serve/heal.py)
    "RAFT_HEAL_BACKOFF_MS",
    "RAFT_HEAL_BACKOFF_MAX_MS",
    "RAFT_HEAL_FLAP_CAP",
    "RAFT_HEAL_WINDOW_MS",
    "RAFT_HEAL_REFILL_MS",
)
