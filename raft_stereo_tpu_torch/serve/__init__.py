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
                  ``/healthz``, ``/metrics``, quotas and read deadlines.

The stream, response cache and fleet are not ported yet. Every recovery
path is testable on the CPU with injected faults
(``raft_stereo_tpu_torch.faults.ServeFaultPlan``).
"""

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
from raft_stereo_tpu_torch.serve.validate import (  # noqa: F401
    AdmissionConfig,
    InputRejected,
)
from raft_stereo_tpu_torch.serve.http import (  # noqa: F401
    HttpConfig,
    HttpFrontend,
)
