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
- ``supervise`` — invocation watch and supervision knobs (its
                  ``Supervisor`` daemon waits for the scheduler, which
                  drives it, and is not exported);
- ``heal``      — the recovery plane's pacing knobs.

The scheduler, stream, response cache, service, HTTP frontend and fleet are
not ported yet. Every recovery path is testable on the CPU with injected
faults (``raft_stereo_tpu_torch.faults.ServeFaultPlan``).
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
from raft_stereo_tpu_torch.serve.supervise import (  # noqa: F401
    InvocationWatch,
    WatchdogTrip,
)
from raft_stereo_tpu_torch.serve.validate import (  # noqa: F401
    AdmissionConfig,
    InputRejected,
)
