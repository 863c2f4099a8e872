"""graftverify — recorded-program analysis of the port.

graftlint (``analysis/checkers/``) proves source-level invariants; the
costliest regressions live one level down, in the program the port runs: a
silent bf16→fp32 upcast in the refinement loop, a breaker rung whose
fallback records the identical program, a closure-held tensor living in a
captured graph's memory, a train step that stops updating in place.  This
package records the port's REAL entry points (the serving programs from
``serve/session.py`` ``build_program``, the train step, the eval forward)
op by op, with the hand-written kernels' launches in the same stream
(``graphs.py``), and walks the recordings with the GV checkers:

GV101  bf16→fp32 upcast in the refinement loop outside the accumulator set
GV102  breaker-ladder rung vacuity + env-knob cache-key sufficiency
GV103  host round trip (.item(), a copy to the host, a data-dependent
       shape, torch.cuda.synchronize) in a hot-path program
GV104  a large tensor the program holds from outside (a baked constant)
GV105  the train step not updating its parameters and moments in place

Unlike the rest of ``analysis/`` this package imports torch — in
``graphs.py``, and elsewhere only inside functions.
"""

from raft_stereo_tpu_torch.analysis.trace.registry import (  # noqa: F401
    KnobFlip, KnobProbe, TraceEntry, TraceRegistry, default_registry)
from raft_stereo_tpu_torch.analysis.trace.runner import (  # noqa: F401
    TraceContext, run_trace_analysis)
