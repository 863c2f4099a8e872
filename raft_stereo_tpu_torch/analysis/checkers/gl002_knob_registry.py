"""GL002 — knob-registry drift.

Every ``RAFT_*`` env read in a program-shaping module (``models/``,
``ops/``, ``corr/`` and ``config.py``, where the port reads its kernel
switches) shapes the program, so it must be part of the serving cache key
— i.e. listed in the one knob registry (``analysis/knobs.py``
``ENV_KNOBS``) that ``serve/session.py`` fingerprints.  A read missing
from the registry is the stale-program class: two requests under
different switch values would silently share one captured program.

The scan also covers the host modules (``serve/``, ``obs/``, ``data/``,
``engine/``, ``parallel/``): a ``RAFT_*`` read there is host or serving
behaviour rather than program shape, so it may live in ANY registry
(``ENV_KNOBS``, ``SERVE_ENV_KNOBS`` or ``HOST_ENV_KNOBS``) — but it must
live somewhere.  A read through a helper that reads the key it is given
(``config._switch_on("RAFT_X")``) counts as a read of that key.
"""

from __future__ import annotations

from typing import Iterator

from raft_stereo_tpu_torch.analysis.checkers.base import Checker
from raft_stereo_tpu_torch.analysis.core import Finding, Project, SourceFile

#: Path segments marking a module whose env reads shape the forward
#: program (the serving cache key must cover them).
FORWARD_DIRS = ("models", "ops", "corr")

#: Module basenames whose env reads shape the program wherever they sit:
#: the port reads its kernel switches in ``config.py``.
FORWARD_FILES = ("config.py",)

#: Path segments whose RAFT_* reads are host/serving behavior: they must
#: appear in SOME registry (ENV_KNOBS counts too — a forward knob read
#: from serve/ is legal) so the flag matrix has one home.
HOST_DIRS = ("serve", "obs", "data", "engine", "parallel")


def is_forward_module(relpath: str) -> bool:
    parts = relpath.split("/")
    return parts[-1] in FORWARD_FILES or \
        any(seg in FORWARD_DIRS for seg in parts[:-1])


def is_host_module(relpath: str) -> bool:
    return any(seg in HOST_DIRS for seg in relpath.split("/")[:-1])


class KnobRegistryChecker(Checker):
    code = "GL002"
    name = "knob-registry"
    description = ("RAFT_* env read missing from the knob registries — "
                   "ENV_KNOBS for program-shaping modules (models/ops/corr, "
                   "config.py), any registry for host modules "
                   "(serve/obs/data/engine/parallel)")

    def check_file(self, project: Project, sf: SourceFile
                   ) -> Iterator[Finding]:
        forward = is_forward_module(sf.relpath)
        host = is_host_module(sf.relpath)
        if not (forward or host):
            return
        for read in project.env_reads(sf):
            if read.key is None or not read.key.startswith("RAFT_"):
                continue
            if forward:
                if read.key not in project.knobs:
                    yield self.finding(
                        sf, read.node,
                        f"env knob {read.key!r} is read in a "
                        "forward-relevant module but missing from ENV_KNOBS "
                        "(raft_stereo_tpu_torch/analysis/knobs.py) — programs "
                        "built under different values would share one "
                        "cache entry; register it (or suppress with a "
                        "reason if it provably cannot change the "
                        "program)")
            elif read.key not in project.knobs and \
                    read.key not in project.serve_knobs:
                yield self.finding(
                    sf, read.node,
                    f"env knob {read.key!r} is read in a host/serving "
                    "module but appears in no registry — add it to "
                    "SERVE_ENV_KNOBS or HOST_ENV_KNOBS "
                    "(raft_stereo_tpu_torch/analysis/knobs.py) with a "
                    "rationale for staying out of the cache-key set, or to "
                    "ENV_KNOBS if it can shape a program")
