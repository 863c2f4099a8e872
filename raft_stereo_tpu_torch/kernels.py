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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "raft_stereo_tpu_torch"
SOURCES = ("corr_lookup", "conv_gru", "motion")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each library's one C entry point (csrc/<name>.cu).
_SIGNATURES = {
    "corr_lookup": ("rst_corr_lookup",
                    [_P, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I, _I, _I,
                     _P, _P]),
    "conv_gru": ("rst_conv_gru",
                 [_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P, _I, _P, _P, _P]),
    "motion": ("rst_motion",
               [_P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                _P, _P, _P, _P]),
}

_lock = threading.Lock()
_entries: Dict[str, ctypes._CFuncPtr] = {}

# Launch counts, one plain integer per kernel ("corr_lookup", "motion") and
# per GRU level for the ConvGRU kernel ("conv_gru:gru08", ...): a wrapper
# adds one where it launches its kernel on CUDA tensors, and nowhere else.
launches: Counter = Counter()


def reset_launches() -> None:
    launches.clear()


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


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile the named sources that have no library yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds; raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n"
                            f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def entry(name: str):
    """The C entry point of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        fn = _entries.get(name)
        if fn is None:
            build([name])
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[name] = fn
        return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
