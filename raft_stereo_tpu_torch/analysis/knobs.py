"""The port's registry of environment knobs: which ``RAFT_*`` switches
shape a program, and which steer only the host.

The counterpart of the JAX package's ``analysis/knobs.py``, listing what the
port reads. The serving session (``serve/session.py``) keys every cached
program on the values of :data:`ENV_KNOBS`, and the breaker's ladder
(``serve/guard.py``) turns them off one rung at a time. The linter
(``python -m raft_stereo_tpu_torch.analysis``, GL002 and GL006) holds the
tree to these tables. Stdlib only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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

# Serving knobs that change no program: each steers host-side serving
# (the batch sizes that are built, the scheduler's idle poll, supervision,
# the HTTP ingress), read once at construction, so none is in a cache key
# (the batch is a key component of its own).
SERVE_ENV_KNOBS: Tuple[str, ...] = (
    "RAFT_BATCH_BUCKETS",   # batch-bucket ladder, e.g. "1,2,4,8"
                            # (serve/session.py, at construction)
    "RAFT_SCHED_TICK_MS",   # scheduler idle poll, ms (serve/service.py)
    "RAFT_WATCHDOG_MS",     # hang-watchdog deadline floor, ms; 0 = off
    "RAFT_RETRY_BUDGET",    # bounded per-request re-admissions
    "RAFT_DRAIN_GRACE_MS",  # graceful-drain hard deadline, ms
    "RAFT_HTTP_PORT",       # listen port of an embedded HttpConfig
                            # (serve/http.py; 0 = ephemeral)
    "RAFT_HTTP_BODY_MAX",   # content-length cap, bytes (serve/http.py)
    "RAFT_HTTP_READ_TIMEOUT_MS",  # per-read socket timeout, ms
    "RAFT_TENANT_RATE",     # per-tenant quota "rate[:burst]" requests/s
)

# Host knobs: telemetry sinks, telemetry sizing and recovery pacing. No
# program depends on any of them.
HOST_ENV_KNOBS: Tuple[str, ...] = (
    "RAFT_TRACE",           # request-trace JSONL sink (obs/tracing.py)
    "RAFT_PROFILE_DIR",     # torch.profiler window output (obs/profiler.py)
    "RAFT_FLIGHT_DIR",      # SLO flight records (obs/flight.py)
    "RAFT_LEDGER",          # program-ledger dump target (obs/ledger.py)
    "RAFT_DECK_TICKS",      # tick-deck ring depth (obs/deck.py)
    "RAFT_CAPACITY_WINDOW_MS",  # saturation window (obs/capacity.py)
    # The data-mesh extent changes the programs, but it keys them as a
    # trailing cache-key component (("mesh", n, epoch), serve/session.py
    # cache_key), never through the fingerprint: the response cache keys on
    # the fingerprint and stays one cache above every device.
    "RAFT_SERVE_MESH_DATA",  # devices one session drives (default 1)
    "RAFT_SERVE_MESH_FALLBACK",  # force one device whatever is asked
    "RAFT_HEAL",            # recovery-plane switch (serve/heal.py)
    "RAFT_HEAL_BACKOFF_MS",
    "RAFT_HEAL_BACKOFF_MAX_MS",
    "RAFT_HEAL_FLAP_CAP",
    "RAFT_HEAL_WINDOW_MS",
    "RAFT_HEAL_REFILL_MS",
    "RAFT_DECODE_MAX_PIXELS",  # decompression-bomb guard: cap on an image's
                            # header-declared pixels (data/frame_utils.py)
    # Streams (serve/stream.py): the session table's size and expiry, and
    # a tolerance compared on the host against the norm every advance
    # program already returns; none reaches a program.
    "RAFT_STREAM_SESSIONS",  # session-table global cap (default 128)
    "RAFT_STREAM_TTL_MS",   # idle-session expiry, ms (default 60 s)
    "RAFT_CONVERGE_TOL",    # convergence exit, px/iter at 1/8 res (0.01)
    # The response cache (serve/cache.py): a host-side store; its keys
    # hold the live program fingerprint, so a knob that does change
    # programs invalidates its entries without being one of these.
    "RAFT_CACHE_BYTES",     # host-RAM budget, bytes (0 = off; CLI 256 MiB)
    "RAFT_CACHE_TTL_MS",    # entry TTL, ms (default 10 min)
    "RAFT_CACHE_NEAR_TOL",  # near-tier signature threshold, gray levels
    "RAFT_CACHE_DIR",       # disk spill of evicted exact-tier entries
    # The fleet (serve/fleet.py): the supervisor's topology and pacing; an
    # instance never reads them.
    "RAFT_FLEET_INSTANCES",  # fleet width (default 2)
    "RAFT_FLEET_RESTART_BUDGET",  # per-slot relaunches a generation (3)
    "RAFT_FLEET_PROBE_MS",  # health-probe period, ms (<= 0: no prober)
    "RAFT_FLEET_WARMUP_TIMEOUT_MS",  # readiness-handshake deadline, ms
)


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """Declared coverage of one module that launches hand-written kernels
    (calls ``kernels.entry(...)``).

    rungs: the ``serve/guard.py`` ``DEFAULT_LADDER`` rungs whose trip turns
        this module's kernels off (or a variant of them: ``lane_pack8``
        turns the int8 ones off).
    gates: modules that consult a rung's switch for this module: the port
        decides the route in the model (``models/``) and launches in the
        ops, so a switch read in a declared gate covers the launch.
    exempt_sites: ``(C entry name, reason)`` for a launch site in the module
        that no rung turns off.
    """

    rungs: Tuple[str, ...] = ()
    gates: Tuple[str, ...] = ()
    exempt_sites: Tuple[Tuple[str, str], ...] = ()


# Every module that launches a hand-written kernel, keyed by path suffix, with
# the rungs that cover it: GL006 checks each rung exists in DEFAULT_LADDER,
# that an env-var rung's switch is consulted in the module or one of its
# gates, that a cfg-field rung names a RAFTStereoConfig field, and that no
# entry outlives its launches.
KERNEL_ENTRY_POINTS: Dict[str, KernelEntry] = {
    "ops/encoder.py": KernelEntry(
        rungs=("fused_encoders", "stream_tail", "lane_pack8")),
    # fused_update (RAFTStereoConfig.fused_update, read by loop_kernels in
    # the model modules) turns the whole loop route off: the serial
    # ConvGRU and motion kernels, gru16+32 and the resident kernel.
    "ops/stream.py": KernelEntry(
        rungs=("fuse_gru1632", "lane_pack8", "fused_update"),
        gates=("models/update.py", "models/raft_stereo.py")),
    "ops/resident.py": KernelEntry(
        rungs=("fuse_iter", "lane_pack8", "corr_kernel", "fused_update"),
        gates=("models/raft_stereo.py",)),
    "corr/reg_cuda.py": KernelEntry(rungs=("corr_kernel", "corr_pack8")),
    "corr/alt_cuda.py": KernelEntry(rungs=("corr_kernel",)),
}
