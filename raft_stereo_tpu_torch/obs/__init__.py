"""Telemetry of the port, the JAX package's ``obs/`` modules that the bench
reads:

- :mod:`~raft_stereo_tpu_torch.obs.metrics`: the metrics registry
  (counters, gauges, bounded reservoir histograms);
- :mod:`~raft_stereo_tpu_torch.obs.profiler`: ``torch.profiler`` windows
  (``RAFT_PROFILE_DIR``) and the device seconds of a trace;
- :mod:`~raft_stereo_tpu_torch.obs.ledger`: the per-program cost and memory
  ledger, the chip peak tables and the ``report`` CLI;
- :mod:`~raft_stereo_tpu_torch.obs.trajectory`: the perf trajectory file and
  its bands (``RAFT_TRAJECTORY``).

``ledger`` and ``trajectory`` are ``python -m`` entry points, so they are not
imported here (runpy warns about a module already in ``sys.modules``):
import them by module path.
"""

from raft_stereo_tpu_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from raft_stereo_tpu_torch.obs.profiler import ProfilerWindow

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "ProfilerWindow"]
