"""Serving, the port's counterpart of the JAX package's ``serve/``.

Layers, bottom up:

- ``validate``  — admission control: structured rejection of malformed
                  requests before they touch the device;
- ``guard``     — the kernel circuit breaker: the port's fast paths with
                  their fallbacks, a trip degrading the session one rung;
- ``session``   — the shape-bucketed program cache (a CUDA graph per
                  program on the card), output validation, breaker-driven
                  rebuild and retry, and the parity canary;
- ``degrade``   — the deadline policy over the segmented refinement;
- ``scheduler`` — iteration-level continuous batching: requests join a
                  running device batch at tick boundaries and exit at
                  segment boundaries (``SessionConfig.max_batch > 1``),
                  on batched CUDA-graph programs;
- ``stream``    — long-lived video sessions: a bounded (LRU + TTL +
                  per-tenant caps) table of held 1/8-res disparities
                  that warm-start consecutive frames through the
                  ``prepare_warm`` program, and the convergence exit
                  (``converged:k``);
- ``cache``     — the two-tier response cache: an exact tier (sha256 of
                  the padded pair + program fingerprint + tier + tenant
                  -> the stored response, bit for bit, no device work,
                  ``cache:exact``) and a near tier (block-mean signature
                  -> a warm seed through ``prepare_warm``,
                  ``warm:cache:k``), byte-bounded, per-tenant sub-caps,
                  TTL, an optional disk spill;
- ``service``   — bounded queue, backpressure, per-request deadlines,
                  /healthz status, the scheduler thread or the workers;
- ``supervise`` — hang watchdogs over every device invocation,
                  tick-loop and uploader liveness, generation bounces with
                  bounded retries, and the graceful drain;
- ``heal``      — the recovery plane's pacing knobs;
- ``wire``      — the codec: strict multipart and raw-pair parsing, the
                  bomb-guarded image decode, the response contract and
                  the HTTP status mapping;
- ``http``      — the stdlib HTTP/1.1 frontend: ``POST /v1/stereo``,
                  ``/healthz``, ``/metrics``, quotas and read deadlines;
- ``fleet``     — the fleet supervisor: N ``serve_stereo`` processes
                  behind one router (headroom-weighted placement,
                  session affinity with drain handoff, replacement of
                  dead instances, rolling deploys, /fleet/healthz and
                  /fleet/metrics).

Every recovery path is testable on the CPU with injected faults
(``raft_stereo_tpu_torch.faults.ServeFaultPlan``).
"""

from raft_stereo_tpu_torch.serve.fleet import (  # noqa: F401
    FleetConfig,
    FleetFrontend,
    FleetSupervisor,
)

from raft_stereo_tpu_torch.serve.guard import (  # noqa: F401
    DEFAULT_LADDER,
    FastPath,
    KernelCircuitBreaker,
)
from raft_stereo_tpu_torch.serve.session import (  # noqa: F401
    PROGRAM_KINDS,
    DeadlineExceeded,
    InferenceFailed,
    InferenceResult,
    InferenceSession,
    SessionConfig,
    SessionError,
    build_program,
    config_fingerprint,
    resolve_env,
)
from raft_stereo_tpu_torch.serve.cache import (  # noqa: F401
    CacheEntry,
    ResponseCache,
)
from raft_stereo_tpu_torch.serve.scheduler import (  # noqa: F401
    BatchScheduler,
)
from raft_stereo_tpu_torch.serve.service import (  # noqa: F401
    ServiceConfig,
    StereoService,
)
from raft_stereo_tpu_torch.serve.supervise import (  # noqa: F401
    InvocationWatch,
    Supervisor,
    WatchdogTrip,
)
from raft_stereo_tpu_torch.serve.stream import (  # noqa: F401
    StreamManager,
    StreamOutcome,
    StreamRunner,
    stream_infer,
)
from raft_stereo_tpu_torch.serve.validate import (  # noqa: F401
    AdmissionConfig,
    InputRejected,
)
from raft_stereo_tpu_torch.serve.http import (  # noqa: F401
    HttpConfig,
    HttpFrontend,
)
