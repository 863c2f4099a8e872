"""graftlock checker registry — GC201-GC206, all constructed against
one shared :class:`LockModel` per run."""

from __future__ import annotations

from raft_stereo_tpu_torch.analysis.concurrency.checkers.gc201_lock_order import \
    LockOrderChecker
from raft_stereo_tpu_torch.analysis.concurrency.checkers.gc202_future_lifecycle \
    import FutureLifecycleChecker
from raft_stereo_tpu_torch.analysis.concurrency.checkers \
    .gc203_blocking_under_lock import BlockingUnderLockChecker
from raft_stereo_tpu_torch.analysis.concurrency.checkers.gc204_sink_under_lock \
    import SinkUnderLockChecker
from raft_stereo_tpu_torch.analysis.concurrency.checkers.gc205_locked_helpers \
    import LockedHelperChecker
from raft_stereo_tpu_torch.analysis.concurrency.checkers.gc206_thread_lifecycle \
    import ThreadLifecycleChecker

ALL_CONCURRENCY_CHECKERS = (
    LockOrderChecker,
    FutureLifecycleChecker,
    BlockingUnderLockChecker,
    SinkUnderLockChecker,
    LockedHelperChecker,
    ThreadLifecycleChecker,
)

__all__ = ["ALL_CONCURRENCY_CHECKERS", "LockOrderChecker",
           "FutureLifecycleChecker", "BlockingUnderLockChecker",
           "SinkUnderLockChecker", "LockedHelperChecker",
           "ThreadLifecycleChecker"]
