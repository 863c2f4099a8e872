"""Concurrency checker base: a :class:`Checker` that shares the one
:class:`LockModel` built per run (the expensive AST pass happens once,
all six GC checkers query it)."""

from __future__ import annotations

from raft_stereo_tpu_torch.analysis.checkers.base import Checker
from raft_stereo_tpu_torch.analysis.concurrency.model import LockModel


class ConcurrencyChecker(Checker):
    def __init__(self, model: LockModel, **_kw):
        self.model = model
