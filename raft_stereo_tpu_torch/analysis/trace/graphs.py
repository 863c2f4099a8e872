"""The recorder: a program's callable run eagerly, op by op.

The counterpart of the JAX package's ``jaxprs.py``.  A program here is the
very callable the serving session captures (``serve/session.py``
``build_program``), the eval forward or the train step.  :func:`record`
runs it once under a ``TorchDispatchMode`` and keeps, in order:

- every aten op: its name, its operands (dtype, shape, device) and what
  each operand is — a program input (``in:<path>``), a parameter, buffer
  or optimizer state of the program (``p:<name>``), a tensor produced
  earlier in the program (``%<n>``), or none of these (``ext``);
- every launch of a hand-written kernel, from a listener on
  ``kernels.count_launch``: the kernels run through ``ctypes``, so the
  dispatcher never sees them;
- every ``torch.cuda.synchronize``.

It also notes, from the Python stack, whether an op ran inside a
hand-written kernel's plain version (a ``*_plain`` function of a kernel
module: on the CPU it stands where the kernel would run, and its body is
exempt the way a Pallas body is in the JAX package), inside the
refinement loop, and at the loop's accumulator line.

:func:`scrubbed_text` renders a recording deterministically: operand labels
instead of data pointers, no addresses.  A recording is never made inside
a CUDA graph capture.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import os
import re
import sys
import textwrap
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")
_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_ANALYSIS_DIR = os.path.join(_PACKAGE_DIR, "analysis")

#: Operand origins.
INPUT, STATE, PRODUCED, EXTERNAL = "input", "state", "produced", "external"


@dataclasses.dataclass(frozen=True)
class Operand:
    """One tensor an op reads or writes."""

    label: str
    origin: str
    dtype: str
    shape: Tuple[int, ...]
    device: str
    nbytes: int

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def render(self) -> str:
        return f"{self.label}:{self.dtype}{list(self.shape)}"


@dataclasses.dataclass
class Op:
    """One aten op of the program."""

    index: int
    name: str
    operands: List[Operand]
    outs: List[Operand]
    text: str
    in_kernel: bool = False
    in_loop: bool = False
    at_acc: bool = False
    site: Optional[str] = None   # innermost frame of the package


@dataclasses.dataclass
class Launch:
    """One launch of a hand-written kernel."""

    index: int
    kernel: str
    variant: Optional[str]
    text: str


@dataclasses.dataclass
class Sync:
    """One ``torch.cuda.synchronize`` inside the program."""

    index: int
    site: Optional[str]
    text: str = "sync torch.cuda.synchronize"


@dataclasses.dataclass
class Recording:
    """What :func:`record` kept of one run of a program."""

    events: list
    state_ptrs_before: Dict[str, int]
    state_ptrs_after: Dict[str, int]
    device: str = "cpu"  # the device of the program's inputs

    @property
    def ops(self) -> List[Op]:
        return [e for e in self.events if isinstance(e, Op)]

    def launches(self, variants: bool = False) -> Dict[str, int]:
        """Kernel launches by kernel, as ``kernels.launches`` counts them;
        with ``variants``, by ``kernel:variant`` where a launch has one."""
        out: Dict[str, int] = {}
        for e in self.events:
            if isinstance(e, Launch):
                k = f"{e.kernel}:{e.variant}" if variants and e.variant else e.kernel
                out[k] = out.get(k, 0) + 1
        return dict(sorted(out.items()))


@dataclasses.dataclass(frozen=True)
class Region:
    """The refinement loop, for GV101: the code object of the function
    holding it, the line span of its ``for`` body, and the line that
    updates the fp32 accumulator."""

    code: object
    lines: Tuple[int, int]
    acc_line: int


def loop_region(fn: Callable, accumulator: str) -> Region:
    """The first top-level ``for`` loop of ``fn``'s body and the line in it
    that assigns ``accumulator``, read from ``fn``'s source (beneath any
    decorator: ``torch.no_grad`` wraps it)."""
    fn = inspect.unwrap(fn)
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    offset = fn.__code__.co_firstlineno - 1
    body = tree.body[0].body
    loop = next(n for n in body if isinstance(n, ast.For))
    acc = next(n for n in ast.walk(loop) if isinstance(n, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id == accumulator for t in n.targets))
    return Region(fn.__code__, (loop.lineno + offset, loop.end_lineno + offset),
                  acc.lineno + offset)


def plain_codes(modules: Sequence[str]) -> frozenset:
    """Code objects of the ``*_plain`` functions of the named modules: a
    kernel's plain version, which the CPU runs in the kernel's place."""
    import importlib
    out = set()
    for name in modules:
        mod = importlib.import_module(name)
        for attr, fn in vars(mod).items():
            if attr.endswith("_plain") and inspect.isfunction(fn) and \
                    fn.__module__ == mod.__name__:
                out.add(fn.__code__)
    return frozenset(out)


_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def _site_of(code) -> Optional[str]:
    """``module.py:Qualname`` of a frame of the port (relative to the
    package), or of code outside it and outside torch (by file name: a
    test's program); None for torch's own frames and the analyzer's."""
    path = code.co_filename
    qual = getattr(code, "co_qualname", code.co_name)
    if path.startswith(_PACKAGE_DIR + os.sep):
        if path.startswith(_ANALYSIS_DIR + os.sep):
            return None
        return f"{os.path.relpath(path, _PACKAGE_DIR).replace(os.sep, '/')}:{qual}"
    if path.startswith(_TORCH_DIR + os.sep) or path.startswith("<"):
        return None
    return f"{os.path.basename(path)}:{qual}"


def _flatten(prefix: str, obj, out: List[Tuple[str, torch.Tensor]]) -> None:
    if isinstance(obj, torch.Tensor):
        out.append((prefix, obj))
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _flatten(f"{prefix}.{k}" if prefix else str(k), obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}[{i}]", v, out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flatten(f"{prefix}.{f.name}", getattr(obj, f.name), out)


def input_leaves(args: Sequence) -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor in a program's arguments (carries
    walked by key)."""
    out: List[Tuple[str, torch.Tensor]] = []
    for i, a in enumerate(args):
        _flatten(f"arg{i}", a, out)
    return out


class _Recorder(TorchDispatchMode):
    def __init__(self, inputs, state, kernel_codes, region: Optional[Region]):
        super().__init__()
        self.labels = WeakTensorKeyDictionary()
        self.origins = WeakTensorKeyDictionary()
        for path, t in inputs:
            self._name(t, f"in:{path}", INPUT)
        for name, t in state.items():
            self._name(t, f"p:{name}", STATE)
        self.kernel_codes = kernel_codes
        self.region = region
        self.events: list = []
        self.produced = 0
        self.thread = threading.get_ident()
        self._sites: Dict[object, Optional[str]] = {}
        self.stop = None  # the frame that called the program

    def _name(self, t, label, origin):
        if t not in self.labels:
            self.labels[t] = label
            self.origins[t] = origin

    def _operand(self, t: torch.Tensor) -> Operand:
        label = self.labels.get(t, "ext")
        origin = self.origins.get(t, EXTERNAL)
        return Operand(label, origin, str(t.dtype).replace("torch.", ""),
                       tuple(int(s) for s in t.shape), str(t.device),
                       int(t.numel() * t.element_size()))

    def _frames(self):
        """(in_kernel, in_loop, at_acc, site) from the Python stack."""
        in_kernel = in_loop = at_acc = False
        site = None
        f = sys._getframe(2)
        while f is not None and f is not self.stop:
            code = f.f_code
            if code in self.kernel_codes:
                in_kernel = True
            if self.region is not None and code is self.region.code:
                lo, hi = self.region.lines
                if lo <= f.f_lineno <= hi:
                    in_loop = True
                    at_acc = at_acc or f.f_lineno == self.region.acc_line
            if site is None:
                if code not in self._sites:
                    self._sites[code] = _site_of(code)
                site = self._sites[code]
            f = f.f_back
        return in_kernel, in_loop, at_acc, site

    def _render(self, x) -> str:
        if isinstance(x, torch.Tensor):
            return self._operand(x).render()
        if isinstance(x, (list, tuple)):
            return "[" + ", ".join(self._render(v) for v in x) + "]"
        return _ADDR_RE.sub("0xX", repr(x))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in: List[torch.Tensor] = []
        for v in list(args) + list(kwargs.values()):
            if isinstance(v, torch.Tensor):
                flat_in.append(v)
            elif isinstance(v, (list, tuple)):
                flat_in.extend(x for x in v if isinstance(x, torch.Tensor))
        operands = [self._operand(t) for t in flat_in]
        arg_text = ", ".join([self._render(a) for a in args] +
                             [f"{k}={self._render(v)}"
                              for k, v in sorted(kwargs.items())])
        out = func(*args, **kwargs)
        outs_flat = [out] if isinstance(out, torch.Tensor) else [
            o for o in (out if isinstance(out, (list, tuple)) else ())
            if isinstance(o, torch.Tensor)]
        ins = {id(t) for t in flat_in}
        for o in outs_flat:
            # An in-place op returns its operand: it keeps its origin.
            if id(o) not in ins:
                self.produced += 1
                self._name(o, f"%{self.produced}", PRODUCED)
        outs = [self._operand(o) for o in outs_flat]
        name = str(func)
        in_kernel, in_loop, at_acc, site = self._frames()
        text = (", ".join(o.render() for o in outs) or "()") + \
            f" = {name}({arg_text})"
        self.events.append(Op(len(self.events), name, operands, outs, text,
                              in_kernel, in_loop, at_acc, site))
        return out

    def on_launch(self, kernel: str, variant: Optional[str]) -> None:
        if threading.get_ident() != self.thread:
            return
        self.events.append(Launch(
            len(self.events), kernel, variant,
            f"launch {kernel}" + (f":{variant}" if variant else "")))

    def on_sync(self) -> None:
        if threading.get_ident() != self.thread:
            return
        f = sys._getframe(2)
        site = None
        while f is not None and site is None:
            site = _site_of(f.f_code)
            f = f.f_back
        self.events.append(Sync(len(self.events), site))


def _ptrs(state: Dict[str, torch.Tensor]) -> Dict[str, int]:
    return {k: int(t.data_ptr()) for k, t in state.items()}


def record(fn: Callable, args: Sequence, state: Optional[Callable[[], Dict]] = None,
           *, kernel_codes: frozenset = frozenset(), region: Optional[Region] = None,
           warmup: bool = True) -> Recording:
    """Run ``fn(*args)`` eagerly and record it.  With ``warmup`` (the
    default) the recorded run is the second: the session captures a program
    after a warm-up run that builds the kernels and fills the caches, so
    the first run's one-time work (a cached resize matrix, a weight layout)
    is not in the program, and two recordings do not depend on which ran
    first.  ``state()`` gives the program's own tensors by name (parameters,
    buffers, optimizer state); it is read before and after the recorded run,
    whose ``data_ptr``s the recording keeps.  Refuses to run inside a CUDA
    graph capture."""
    from raft_stereo_tpu_torch import kernels
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a program is never recorded inside a CUDA graph "
                           "capture")
    if warmup:
        fn(*args)
    state_fn = state or (lambda: {})
    before = state_fn()
    ptrs_before = _ptrs(before)
    inputs = input_leaves(args)
    rec = _Recorder(inputs, before, kernel_codes, region)
    sync = torch.cuda.synchronize

    def synchronize(*a, **kw):
        rec.on_sync()
        return sync(*a, **kw)
    rec.stop = sys._getframe(0)
    kernels.add_launch_listener(rec.on_launch)
    torch.cuda.synchronize = synchronize
    try:
        with rec:
            out = fn(*args)
        del out
    finally:
        torch.cuda.synchronize = sync
        kernels.remove_launch_listener(rec.on_launch)
    device = str(inputs[0][1].device) if inputs else "cpu"
    return Recording(rec.events, ptrs_before, _ptrs(state_fn()), device)


def scrubbed_text(recording: Recording) -> str:
    """Deterministic program text: one line an event, operand labels in
    place of pointers, addresses scrubbed."""
    return "\n".join(e.text for e in recording.events)


def uses(recording: Recording) -> Dict[str, List[Op]]:
    """label -> the ops that read it, in order."""
    out: Dict[str, List[Op]] = {}
    for op in recording.ops:
        for o in op.operands:
            if o.origin == PRODUCED:
                out.setdefault(o.label, []).append(op)
    return out
