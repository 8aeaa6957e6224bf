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
import re
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
    shared library, unless it exists. nvcc's report is kept beside it
    (``.ptxas.txt``) and read into :data:`build_log`."""
    global build_log
    out = library_path()
    report = out.with_suffix(".ptxas.txt")
    if out.exists():
        if report.exists():
            build_log = report.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, srcs = _nvcc(), _sources()
    objs = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        with ThreadPoolExecutor(len(srcs)) as pool:
            logs = list(pool.map(_nvcc_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                                             for src, obj in zip(srcs, objs)]))
        logs.append(_nvcc_run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs),
                               "-ldl"]))
        build_log = "".join(logs)
        report.write_text(build_log)
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


def kernel_name(mangled: str) -> str:
    """A kernel's source name and template arguments from its mangled
    name (``gmm_scores_kernel<1,0>``, ``row_gather_kernel<int4>``)."""
    for m in re.finditer(r"_kernel", mangled):
        for n in range(8, m.end()):  # the shortest length-prefixed identifier
            ident = mangled[m.end() - n:m.end()]
            if ident[0].isalpha() and mangled[:m.end() - n].endswith(str(n)):
                tail = mangled[m.end():]
                args = re.findall(r"Lb([01])E", tail)
                if not args and tail.startswith("I"):
                    args = [re.sub(r"^\d+", "", tail[1:tail.index("E")])]
                    args = ["int" if a == "i" else a for a in args]
                return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_report() -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from
    ptxas' report of the last build (:data:`build_log`)."""
    report, cur = {}, None
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = kernel_name(entry.group(1))
            report[cur] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
        elif cur is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                report[cur]["spill_stores"], report[cur]["spill_loads"] = map(int, spill.groups())
            if regs:
                report[cur]["registers"] = int(regs.group(1))
    return report


#: the SASS instructions :func:`sass_counts` counts: Hopper's warpgroup
#: products (wgmma), TMA tensor loads, and Ampere's warp products (mma.sync)
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(path: Optional[Path] = None) -> dict:
    """``{kernel: {op: count}}`` of the built library's kernels for the
    :data:`SASS_OPS`, read with the toolkit's ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", str(path or build())], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}): {proc.stderr}")
    counts, cur = {}, None
    for line in proc.stdout.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            cur = kernel_name(fn.group(1))
            counts[cur] = dict.fromkeys(SASS_OPS, 0)
        elif cur is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[cur][op] += 1
    return counts


def check(code: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")
