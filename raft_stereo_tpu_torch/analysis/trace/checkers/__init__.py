"""GV-series trace checkers. Registration order = code order."""

from raft_stereo_tpu_torch.analysis.trace.checkers.gv101_dtype_discipline import \
    DtypeDisciplineChecker
from raft_stereo_tpu_torch.analysis.trace.checkers.gv102_ladder_vacuity import \
    LadderVacuityChecker
from raft_stereo_tpu_torch.analysis.trace.checkers.gv103_host_round_trips import \
    HostRoundTripChecker
from raft_stereo_tpu_torch.analysis.trace.checkers.gv104_constant_bloat import \
    ConstantBloatChecker
from raft_stereo_tpu_torch.analysis.trace.checkers.gv105_in_place import \
    InPlaceUpdateChecker

ALL_TRACE_CHECKERS = (
    DtypeDisciplineChecker,
    LadderVacuityChecker,
    HostRoundTripChecker,
    ConstantBloatChecker,
    InPlaceUpdateChecker,
)
