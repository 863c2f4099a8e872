"""GL006 — kill-switch / fallback-ladder coverage of the kernel launches.

``kernels.entry(...)`` is the port's ``pl.pallas_call``: every module that
calls it launches a hand-written kernel, a production risk the serving
circuit breaker must be able to turn OFF.  Coverage is declared once, in
``analysis/knobs.py`` ``KERNEL_ENTRY_POINTS``, and this checker keeps the
declaration honest:

- a module that calls ``kernels.entry`` with no registry entry is flagged
  — a new kernel cannot ship without deciding its fallback story;
- declared rungs must exist in ``serve/guard.py`` ``DEFAULT_LADDER``
  (AST cross-check — renaming a rung can't silently orphan a kernel);
- an env-var rung's switch must be consulted in the module or in one of
  the entry's declared gates (the port decides a route in ``models/`` and
  launches in the ops).  A call of a ``config.py`` helper counts as a read
  of the keys its body reads, resolved from the helper's body;
- a cfg-field rung's field must exist on the model config dataclass;
- an exempt launch site must name a ``kernels.entry`` call of the module,
  and an entry whose module no longer launches anything is stale (the
  registry never overstates coverage).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from raft_stereo_tpu_torch.analysis.checkers.base import (Checker,
                                                          call_name_candidates)
from raft_stereo_tpu_torch.analysis.core import Finding, Project, SourceFile

REGISTRY_HINT = "raft_stereo_tpu_torch/analysis/knobs.py KERNEL_ENTRY_POINTS"

#: The call that loads (and so precedes every launch of) a kernel.
LAUNCH_CALL = "kernels.entry"


def _suffix_match(relpath: str, key: str) -> bool:
    """Path-segment-bounded suffix match: 'xcorr/reg_cuda.py' must NOT
    inherit the 'corr/reg_cuda.py' entry."""
    return relpath == key or relpath.endswith("/" + key)


def _launch_calls(sf: SourceFile) -> List[ast.Call]:
    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) and \
                LAUNCH_CALL in call_name_candidates(sf, node.func):
            out.append(node)
    return sorted(out, key=lambda c: (c.lineno, c.col_offset))


def _site_name(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) and \
            isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


class KillSwitchCoverageChecker(Checker):
    code = "GL006"
    name = "kill-switch-coverage"
    description = ("kernels.entry launch site without a registered kill "
                   "switch + guard-ladder rung (or explicit exemption)")

    def check_project(self, project: Project) -> Iterator[Finding]:
        ladder = project.ladder()
        rung_by_name = {r.name: r for r in (ladder or [])}
        config_fields = project.config_fields()
        matched_entries: Set[str] = set()

        for sf in project.files:
            if sf.tree is None:
                continue
            calls = _launch_calls(sf)
            if not calls:
                continue
            entry_key = next((k for k in project.kernel_entries
                              if _suffix_match(sf.relpath, k)), None)
            if entry_key is None:
                yield self.finding(
                    sf, calls[0],
                    f"module launches hand-written kernels "
                    f"({LAUNCH_CALL}) but has no entry in {REGISTRY_HINT} — "
                    "declare the ladder rungs whose kill switches cover it "
                    "(or exempt a launch site, saying why no rung turns it "
                    "off)")
                continue
            matched_entries.add(entry_key)
            entry = project.kernel_entries[entry_key]
            exempt: Dict[str, str] = dict(entry.exempt_sites)
            names = {_site_name(c) for c in calls}
            for site in sorted(set(exempt) - names):
                yield self.finding(
                    sf, calls[0],
                    f"stale exempt site {site!r}: this module makes no "
                    f"{LAUNCH_CALL}({site!r}) call — remove it from "
                    f"{REGISTRY_HINT}")
            covered = [c for c in calls if _site_name(c) not in exempt]
            if not covered:
                continue
            first = covered[0]
            if not entry.rungs:
                yield self.finding(
                    sf, first,
                    f"registry entry for this module declares no ladder "
                    f"rungs for its launch sites and exempts none of them "
                    f"({REGISTRY_HINT})")
                continue
            consulted = project.keys_consulted(sf)
            for gate in entry.gates:
                gsf = project.find(gate)
                if gsf is None or gsf.tree is None:
                    yield self.finding(
                        sf, first,
                        f"declared gate {gate!r} is not in the analyzed "
                        f"tree ({REGISTRY_HINT}) — a switch read there "
                        "cannot be shown to cover this module")
                    continue
                consulted |= project.keys_consulted(gsf)
            for rung_name in entry.rungs:
                if ladder is not None and rung_name not in rung_by_name:
                    yield self.finding(
                        sf, first,
                        f"declared ladder rung {rung_name!r} does not "
                        "exist in DEFAULT_LADDER (serve/guard.py) — the "
                        "breaker cannot trip a rung that isn't there")
                    continue
                rung = rung_by_name.get(rung_name)
                if rung is None:
                    continue  # no ladder in the analyzed set
                if rung.env_var is not None and \
                        rung.env_var not in consulted:
                    where = "this module" + (
                        " or its gates (" + ", ".join(entry.gates) + ")"
                        if entry.gates else "")
                    yield self.finding(
                        sf, first,
                        f"rung {rung_name!r} kill switch {rung.env_var!r} "
                        f"is never read in {where} — flipping it would "
                        "kill nothing here; consult the switch on the path "
                        f"that reaches {LAUNCH_CALL}")
                if rung.cfg_field is not None and \
                        config_fields is not None and \
                        rung.cfg_field not in config_fields:
                    yield self.finding(
                        sf, first,
                        f"rung {rung_name!r} config switch "
                        f"{rung.cfg_field!r} is not a field of the model "
                        "config — the breaker's cfg rewrite would be a "
                        "no-op")

        for key, entry in sorted(project.kernel_entries.items()):
            sf = project.find(key)
            if sf is None or sf.tree is None:
                continue  # module outside the analyzed set
            if key not in matched_entries and not _launch_calls(sf):
                yield self.finding(
                    sf, sf.tree,
                    f"stale registry entry: {key} no longer calls "
                    f"{LAUNCH_CALL} — remove it from {REGISTRY_HINT} so the "
                    "registry never overstates coverage")
