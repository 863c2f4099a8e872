"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
are built at first use into ``build/raft_stereo_tpu_torch/`` at the root of
the checkout, under a name that carries a hash of the sources and flags, so
an edited source is rebuilt and a stale library is never loaded.
:func:`build` compiles several sources at once, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "raft_stereo_tpu_torch"
SOURCES = ("corr_lookup", "corr_alt", "conv_gru", "motion", "gru1632", "resident",
           "enc_stem", "enc_pass", "enc_point")
# -fmad=false: no multiply and add is contracted into a fused multiply-add
# behind the source's back, so the serial kernels and the persistent ones
# that inline the same stages round the same way (fmaf stays explicit).
# -Xptxas=-v: each kernel's registers and spills, kept in the build log
# beside the library (:func:`build_log`).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each library's C entry point (csrc/<name>.cu), and of a second
# symbol of one of them (a third element names its source).
_SIGNATURES = {
    "corr_lookup": ("rst_corr_lookup",
                    [_P, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I, _I, _I,
                     _P, _I, _P, _P]),
    "corr_alt": ("rst_corr_alt",
                 [_P, _P, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I, _I, _I, _I, _F,
                  _I, _P, _P]),
    "conv_gru": ("rst_conv_gru",
                 [_P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _I, _P, _P, _P]),
    "motion": ("rst_motion",
               [_P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                _P, _P, _P, _P]),
    "gru1632": ("rst_gru1632",
                [_P] * 4 + [_I] + [_P] * 3 + [_I, _P] + [_I] * 6 + [_P] * 8 + [_I] * 2
                + [_P] * 16),
    # More symbols of csrc/gru1632.cu: the size of its counter buffer, and
    # its block.
    "gru1632_counters": ("rst_gru1632_counters", [_I, _I, _I], "gru1632"),
    "gru1632_plan": ("rst_gru1632_plan", [_I, ctypes.POINTER(_I)], "gru1632"),
    "resident": ("rst_resident",
                 [_P, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I, _I, _P, _P, _P, _P,
                  _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                  _P, _I, _P, _P, _P, _P, _P, _I] + [_P] * 11),
    # More symbols of csrc/resident.cu: the size of its counter buffer, and
    # the loop engine's block.
    "resident_counters": ("rst_resident_counters", [_I, _I], "resident"),
    "resident_plan": ("rst_resident_plan", [ctypes.POINTER(_I)], "resident"),
    "enc_stem": ("rst_enc_stem", [_P, _P, _P, _I, _I, _P, _P, _P, _P]),
    # A second symbol of csrc/enc_stem.cu: the stem's plan.
    "enc_stem_plan": ("rst_enc_stem_plan", [_I, _I, ctypes.POINTER(_I)], "enc_stem"),
    "enc_pass": ("rst_enc_pass",
                 [_I, _I] + [_P] * 6 + [_I, _I, _I, _P, _P, _I] + [_P] * 7),
    # A second symbol of csrc/enc_pass.cu: the pass's launch plan.
    "enc_pass_plan": ("rst_enc_pass_plan", [_I] * 5 + [ctypes.POINTER(_I)], "enc_pass"),
    "enc_point": ("rst_enc_point", [_I, _I] + [_P] * 9 + [_I, _I] + [_P] * 5),
}

_lock = threading.Lock()
_entries: Dict[str, ctypes._CFuncPtr] = {}

# Launch counts, one plain integer per kernel ("corr_lookup", "corr_alt",
# "motion", "gru1632", "fused_iter", "enc_stem", "enc_pass", "enc_point3",
# "enc_point2") and per GRU level for the ConvGRU kernel ("conv_gru:gru08",
# ...): a wrapper adds one where it launches its kernel on CUDA tensors, and
# nowhere else.
launches: Counter = Counter()
# Some launches once more, by variant. The encoder kernels': the norm the
# launch applies ("bn": BatchNorm folded, no statistics; "instance":
# statistics taken and applied), the pass kind and the channels, as
# "enc_stem:instance", "enc_pass:mid1/bn/64", "enc_point2:instance/128"; it
# tells the context net's launches from the feature net's, and "/q8" ends the
# quantize-on-exit ones ("enc_pass:raw1/bn/128/q8"). The lookup's and the
# resident kernel's on int8 levels (RAFT_CORR_PACK8): "corr_lookup:pack8",
# "fused_iter:pack8"; the GRU kernels' on int8 czrq (RAFT_LANE_PACK8):
# "conv_gru:gru08:lane8", "gru1632:lane8", "fused_iter:lane8", and
# "fused_iter:pack8+lane8" under both. A launch that ran an optional stage
# is counted under the stage too, beside its variant's count: "gru1632:up08",
# the gru16+32 launches that built gru08's upsampled input. Added to beside
# ``launches``, at the same place.
variants: Counter = Counter()

# Callables ``(kernel, variant)`` told of every launch as it is counted: the
# analysis recorder (``analysis/trace/graphs.py``) puts the launches into a
# program's op stream this way, since the dispatcher never sees a kernel
# launched through ctypes.
_listeners: list = []


def count_launch(kernel: str, variant: Optional[str] = None,
                 stage: Optional[str] = None) -> None:
    """One launch of ``kernel``, in its ``variant`` where it has one (a
    launch without one is counted in ``launches`` alone), and under the
    optional ``stage`` it ran, if any. Listeners get the two joined by
    ``+``."""
    launches[kernel] += 1
    tags = [t for t in (variant, stage) if t is not None]
    for tag in tags:
        variants[f"{kernel}:{tag}"] += 1
    for listener in tuple(_listeners):
        listener(kernel, "+".join(tags) or None)


def add_launch_listener(fn) -> None:
    _listeners.append(fn)


def remove_launch_listener(fn) -> None:
    if fn in _listeners:
        _listeners.remove(fn)


def reset_launches() -> None:
    launches.clear()
    variants.clear()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives, keyed by the hash of
    the source, the shared headers and the flags."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that have no library yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds each compile took
    from the start, by source (none for a source already built); raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    seconds: Dict[str, float] = {}
    if not todo:
        return seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(f".{os.getpid()}.log")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        # graftlint: disable=GC204 (the compiler's log; serializing builds is the lock's purpose)
        with open(log, "wb") as sink:
            procs.append((name, out, tmp, log, subprocess.Popen(
                cmd, stdout=sink, stderr=subprocess.STDOUT)))
    pending = list(procs)
    while pending:  # each compiler's own wall time, whichever ends first
        # graftlint: disable=GC203 (build serialization is the lock's purpose)
        time.sleep(0.05)
        for item in [p for p in pending if p[-1].poll() is not None]:
            seconds[item[0]] = time.perf_counter() - t0
            pending.remove(item)
    failures = []
    for name, out, tmp, log, proc in procs:
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n"
                            f"{log.read_text(errors='replace')}")
            tmp.unlink(missing_ok=True)
            log.unlink(missing_ok=True)
        else:
            # graftlint: disable=GC204 (atomic publish of the build log under the build lock)
            os.replace(log, out.with_suffix(".log"))
            # graftlint: disable=GC204 (atomic .so publish under the build lock)
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output of the build of ``csrc/<name>.cu`` (ptxas's
    resource lines among it), empty if there is none."""
    log = library_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def entry(name: str):
    """The C entry point ``name`` of ``_SIGNATURES``, from the library of
    ``csrc/<name>.cu`` or of the source the entry names, building it if
    needed."""
    with _lock:
        fn = _entries.get(name)
        if fn is None:
            symbol, argtypes, *source = _SIGNATURES[name]
            source = source[0] if source else name
            build([source])
            fn = getattr(ctypes.CDLL(str(library_path(source))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[name] = fn
        return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
