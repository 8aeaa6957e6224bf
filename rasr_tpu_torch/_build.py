"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together (``csrc/*.cuh`` holds what
several sources include), and the objects link into
ONE shared library with a plain C interface, at first use, under
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> argtypes of each C entry point (all return cudaError_t as int)
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {
    # x, packed [a; b] operand, c_k, out, N, D, M, K, max_approx, stream
    "gmm_scores_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # frames, packed DFT basis, mel, dct, out, B, T, stride_b, stride_t, L,
    # bins, num_mel, num_ceps, log_floor, stream
    "mfcc_frames_launch": [
        _P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, ctypes.c_longlong,
        _I, _I, _I, _I, ctypes.c_float, _P,
    ],
    # w_state, w_score, combo, emis, pre, w2, word, lemma, next, spk,
    # n = B * KW, KW, combo width, C, C_sp, stream
    "wordend_block_launch": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P,
    ],
    # table, idx, out, N, C, vec4, stream
    "row_gather_launch": [_P, _P, _P, _I, _I, _I, _P],
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
    """The translation units: one nvcc each."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Content-addressed path of the built library: an edit to a source
    or to a header it includes rebuilds instead of loading a stale
    binary."""
    h = hashlib.sha256()
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librasr_kernels_{h.hexdigest()[:16]}.so"


def _nvcc_run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    return proc.stderr


def build() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc per file, all at once) and link the
    shared library, unless it exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, srcs = _nvcc(), _sources()
    objs = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        with ThreadPoolExecutor(len(srcs)) as pool:
            logs = list(pool.map(_nvcc_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                                             for src, obj in zip(srcs, objs)]))
        logs.append(_nvcc_run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]))
        build_log = "".join(logs)
        os.replace(tmp, out)
    finally:
        for path in [*objs, tmp]:
            path.unlink(missing_ok=True)
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
