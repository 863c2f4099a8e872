"""The port's analysis suites: graftlint (the AST stage) and graftverify
(the recorded-program stage, ``analysis/trace/``).

GL001  kill-switch read at import scope or inside a cached function
GL002  RAFT_* env read missing from the knob registries
GL003  program fingerprint not covering every model-config field
GL004  instance attribute mutated both inside and outside its lock
GL005  impure host call in code a CUDA graph captures or a backward reruns
GL006  kernels.entry launch site without kill switch + ladder registration

Run ``python -m raft_stereo_tpu_torch.analysis`` (the whole package) or
with ``--changed-only`` (git-changed files only).  Suppress a finding
inline with ``# graftlint: disable=GLxxx (reason)``.  ``--trace`` adds
GV101-GV105 (``analysis/trace/``).

This package's modules are import-light by design: no torch, no numpy —
the linter and the knob registry work without them.  Only the ``trace``
subpackage imports torch, and only when ``--trace`` asks for it.
"""

from raft_stereo_tpu_torch.analysis.core import (Finding, Project,  # noqa: F401
                                                 run_analysis)
from raft_stereo_tpu_torch.analysis.knobs import (ENV_KNOBS,  # noqa: F401
                                                  KERNEL_ENTRY_POINTS,
                                                  KernelEntry)
