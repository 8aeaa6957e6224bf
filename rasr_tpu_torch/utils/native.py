"""ctypes binding for the native host library (``native/arpa.cc``, ``native/rtar.cc``).

The port's counterpart of ``rasr_tpu/utils/native.py``, over the same
C++ sources. On first use it compiles them with ``g++ -O3 -std=c++17
-fPIC -shared -lz`` (the flags of ``native/Makefile``) into the port's
git-ignored build directory, ``rasr_tpu_torch/csrc/build/``, under a name
keyed by a hash of the sources; it never writes into ``native/``. This is
host code, not a kernel: every caller falls back to pure Python when the
library cannot be built or loaded, and :data:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("arpa.cc", "rtar.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: why the library is unavailable ("" while it loads or was never asked for)
build_error = ""


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librasr_native-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent processes never
    # load a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS,
           *[str(NATIVE_DIR / s) for s in SOURCES], "-o", str(tmp), "-shared", "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built on demand; None if unavailable."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except subprocess.CalledProcessError as exc:
            build_error = f"g++ failed: {exc.stderr.strip()[-2000:]}"
            return None
        except (OSError, subprocess.SubprocessError) as exc:
            build_error = f"{type(exc).__name__}: {exc}"
            return None
        lib.rasr_arpa_to_lmbin.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.rasr_arpa_to_lmbin.restype = ctypes.c_int
        lib.rasr_last_error.restype = ctypes.c_char_p
        lib.rasr_rtar_scan.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long]
        lib.rasr_rtar_scan.restype = ctypes.c_long
        lib.rasr_rtar_read.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p,
        ]
        lib.rasr_rtar_read.restype = ctypes.c_int
        lib.rasr_rtar_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def arpa_to_lmbin(arpa_path: str, out_path: str) -> bool:
    """Parse ARPA -> .lmbin with the native parser. False if unavailable."""
    lib = load_native()
    if lib is None:
        return False
    rc = lib.rasr_arpa_to_lmbin(arpa_path.encode(), out_path.encode())
    if rc != 0:
        raise IOError(f"native ARPA parse failed ({rc}): {lib.rasr_last_error().decode()}")
    return True


def rtar_scan(path: str) -> Optional[Dict[str, Tuple[int, int, int, int]]]:
    """Native archive index scan -> {name: (offset, flags, raw, comp)}.
    None if the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    need = lib.rasr_rtar_scan(path.encode(), None, 0)
    if need < 0:
        raise IOError(lib.rasr_rtar_last_error().decode())
    buf = ctypes.create_string_buffer(int(need))
    lib.rasr_rtar_scan(path.encode(), buf, need)
    index: Dict[str, Tuple[int, int, int, int]] = {}
    for line in buf.raw[:need].decode().splitlines():
        name, offset, flags, raw, comp = line.split("\t")
        index[name] = (int(offset), int(flags), int(raw), int(comp))
    return index


def rtar_read(path: str, offset: int, flags: int, raw_len: int, comp_len: int
              ) -> Optional[bytes]:
    lib = load_native()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(raw_len)
    rc = lib.rasr_rtar_read(path.encode(), offset, flags, raw_len, comp_len, out)
    if rc != 0:
        raise IOError(lib.rasr_rtar_last_error().decode())
    return out.raw
