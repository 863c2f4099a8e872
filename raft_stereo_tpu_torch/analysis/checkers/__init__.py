"""graftlint checker registry — one module per mechanized bug class."""

from raft_stereo_tpu_torch.analysis.checkers.base import Checker  # noqa: F401
from raft_stereo_tpu_torch.analysis.checkers.gl001_import_time_switch import \
    ImportTimeSwitchChecker
from raft_stereo_tpu_torch.analysis.checkers.gl002_knob_registry import \
    KnobRegistryChecker
from raft_stereo_tpu_torch.analysis.checkers.gl003_cache_key import \
    CacheKeyCompletenessChecker
from raft_stereo_tpu_torch.analysis.checkers.gl004_lock_discipline import \
    LockDisciplineChecker
from raft_stereo_tpu_torch.analysis.checkers.gl005_trace_purity import \
    TracePurityChecker
from raft_stereo_tpu_torch.analysis.checkers.gl006_kill_switch import \
    KillSwitchCoverageChecker

ALL_CHECKERS = (
    ImportTimeSwitchChecker,
    KnobRegistryChecker,
    CacheKeyCompletenessChecker,
    LockDisciplineChecker,
    TracePurityChecker,
    KillSwitchCoverageChecker,
)
