"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, at first use, under
``csrc/build/`` (git-ignored). The library is loaded with ``ctypes``:
device pointers and the CUDA stream pass as ``c_void_p``, sizes as
``c_int``. Every C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on a non-zero code, so a refused launch (too
many threads, too much shared memory) never passes silently.

There is no fallback: a failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# name -> argtypes of each C entry point (all return cudaError_t as int)
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {
    # x, a_k, b_k, c_k, out, N, D, M, K, max_approx, stream
    "gmm_scores_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # frames, cosw, sinw, mel, dct, out, B, T, stride_b, stride_t, L,
    # bins, num_mel, num_ceps, log_floor, stream
    "mfcc_frames_launch": [
        _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, ctypes.c_longlong,
        _I, _I, _I, _I, ctypes.c_float, _P,
    ],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: nvcc's report (ptxas register / shared-memory usage) of the last build
build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from source at first use"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Content-addressed path of the built library (a source edit
    rebuilds instead of loading a stale binary)."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librasr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    build_log = proc.stderr
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")
