"""Telemetry of the port, the JAX package's ``obs/`` modules that the bench
and the serving session read:

- :mod:`~raft_stereo_tpu_torch.obs.metrics`: the metrics registry
  (counters, gauges, bounded reservoir histograms);
- :mod:`~raft_stereo_tpu_torch.obs.profiler`: ``torch.profiler`` windows
  (``RAFT_PROFILE_DIR``) and the device seconds of a trace;
- :mod:`~raft_stereo_tpu_torch.obs.ledger`: the per-program cost and memory
  ledger, the chip peak tables and the ``report`` CLI;
- :mod:`~raft_stereo_tpu_torch.obs.trajectory`: the perf trajectory file and
  its bands (``RAFT_TRAJECTORY``);
- :mod:`~raft_stereo_tpu_torch.obs.tracing`: per-request span timelines
  (``RAFT_TRACE``);
- :mod:`~raft_stereo_tpu_torch.obs.flight`: the SLO flight recorder
  (``RAFT_FLIGHT_DIR``);
- :mod:`~raft_stereo_tpu_torch.obs.deck`: the tick flight-deck
  (``RAFT_DECK_TICKS``) and its ``report`` CLI;
- :mod:`~raft_stereo_tpu_torch.obs.usage` and
  :mod:`~raft_stereo_tpu_torch.obs.capacity`: per-tenant usage and the
  capacity and saturation model.

``ledger``, ``trajectory`` and ``deck`` are ``python -m`` entry points, so
they are not imported here (runpy warns about a module already in
``sys.modules``): import them by module path.
"""

from raft_stereo_tpu_torch.obs.flight import FlightRecorder
from raft_stereo_tpu_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from raft_stereo_tpu_torch.obs.profiler import ProfilerWindow
from raft_stereo_tpu_torch.obs.tracing import NULL_TRACE, RequestTrace, Span, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "ProfilerWindow",
           "FlightRecorder", "NULL_TRACE", "RequestTrace", "Span", "Tracer"]
