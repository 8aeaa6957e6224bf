"""Cache archives: named compressed streams in one container file.

Re-implements the role of the reference's archive layer
(ref: src/Core/Archive.*, src/Core/FileArchive.*, Core::BundleArchive):
feature caches, alignment caches and lattice archives are keyed by
segment id and must be appendable, seekable and mergeable so reruns are
incremental and multi-job outputs combine.

Format (``RTAR1``): append-only record log —
``magic | {u32 name_len, name, u8 flags, u64 raw_len, u64 comp_len, payload}*``
with an optional sidecar index ``<path>.idx`` (rebuilt on open if stale).
flags bit0 = zlib-compressed, bit1 = tombstone (deletion marker).

A directory of loose files (one file per entry) and ``.bundle`` text files
listing member archives are also supported, mirroring the reference's
directory archives and bundles. The C++ fast path (native/archive.cc)
implements the same format; this module is the always-available fallback
and the format's source of truth.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

MAGIC = b"RTAR1\n"
_HDR = struct.Struct("<I")  # name length
_REC = struct.Struct("<BQQ")  # flags, raw_len, comp_len

FLAG_COMPRESSED = 1
FLAG_TOMBSTONE = 2


class FileArchive:
    """Single-file append-only archive of named byte streams."""

    def __init__(self, path: str, mode: str = "r", compress: bool = True):
        assert mode in ("r", "w", "a")
        self.path = path
        self.mode = mode
        self.compress = compress
        self._index: Dict[str, Tuple[int, int, int, int]] = {}  # name -> (off, flags, raw, comp)
        if mode == "w" or (mode == "a" and not os.path.exists(path)):
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "w+b")
            self._fh.write(MAGIC)
        else:
            self._fh = open(path, "r+b" if mode == "a" else "rb")
            self._load_index()
        if mode in ("w", "a"):
            self._fh.seek(0, os.SEEK_END)

    # ----------------------------------------------------------------- index
    def _load_index(self) -> None:
        idx_path = self.path + ".idx"
        size = os.path.getsize(self.path)
        if os.path.exists(idx_path):
            try:
                with open(idx_path, "r", encoding="utf-8") as fh:
                    meta = json.load(fh)
                if meta.get("size") == size:
                    self._index = {k: tuple(v) for k, v in meta["entries"].items()}
                    return
            except Exception:
                pass
        self._scan()

    def _scan(self) -> None:
        self._index.clear()
        self._fh.seek(0)
        if self._fh.read(len(MAGIC)) != MAGIC:
            raise IOError(f"{self.path}: not a RTAR1 archive")
        try:  # native scan fast path (multi-GB caches with many entries)
            from .native import rtar_scan

            native = rtar_scan(self.path)
        except Exception:
            native = None
        if native is not None:
            # the native index carries PAYLOAD offsets; the internal
            # index (and the .idx sidecar) key RECORD starts — convert
            self._index = {
                name: (
                    off - _REC.size - len(name.encode("utf-8")) - _HDR.size,
                    flags, raw, comp,
                )
                for name, (off, flags, raw, comp) in native.items()
            }
            return
        while True:
            pos = self._fh.tell()
            head = self._fh.read(_HDR.size)
            if len(head) < _HDR.size:
                break
            (name_len,) = _HDR.unpack(head)
            name = self._fh.read(name_len).decode("utf-8")
            flags, raw_len, comp_len = _REC.unpack(self._fh.read(_REC.size))
            if flags & FLAG_TOMBSTONE:
                self._index.pop(name, None)
            else:
                self._index[name] = (pos, flags, raw_len, comp_len)
            self._fh.seek(comp_len, os.SEEK_CUR)

    def write_index(self) -> None:
        with open(self.path + ".idx", "w", encoding="utf-8") as fh:
            json.dump(
                {"size": os.path.getsize(self.path), "entries": self._index}, fh
            )

    # ------------------------------------------------------------------- api
    def __contains__(self, name: str) -> bool:
        return name in self._index

    def keys(self) -> List[str]:
        return list(self._index.keys())

    def write(self, name: str, data: bytes) -> None:
        assert self.mode in ("w", "a"), "archive opened read-only"
        flags = 0
        payload = data
        if self.compress:
            comp = zlib.compress(data, 6)
            if len(comp) < len(data):
                payload, flags = comp, FLAG_COMPRESSED
        self._fh.seek(0, os.SEEK_END)
        pos = self._fh.tell()
        encoded = name.encode("utf-8")
        self._fh.write(_HDR.pack(len(encoded)))
        self._fh.write(encoded)
        self._fh.write(_REC.pack(flags, len(data), len(payload)))
        self._fh.write(payload)
        self._index[name] = (pos, flags, len(data), len(payload))

    def delete(self, name: str) -> None:
        assert self.mode in ("w", "a")
        encoded = name.encode("utf-8")
        self._fh.seek(0, os.SEEK_END)
        self._fh.write(_HDR.pack(len(encoded)))
        self._fh.write(encoded)
        self._fh.write(_REC.pack(FLAG_TOMBSTONE, 0, 0))
        self._index.pop(name, None)

    def read(self, name: str) -> bytes:
        pos, flags, raw_len, comp_len = self._index[name]
        encoded_len = len(name.encode("utf-8"))
        self._fh.seek(pos + _HDR.size + encoded_len + _REC.size)
        payload = self._fh.read(comp_len)
        if flags & FLAG_COMPRESSED:
            payload = zlib.decompress(payload)
        if len(payload) != raw_len:
            raise IOError(f"{self.path}:{name}: corrupt entry")
        return payload

    def close(self) -> None:
        if self.mode in ("w", "a"):
            self._fh.flush()
            self.write_index()
        self._fh.close()

    def __enter__(self) -> "FileArchive":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class BundleArchive:
    """Read-only view over several archives listed in a ``.bundle`` file.

    (ref: Core::BundleArchive — merged multi-job outputs.)
    """

    def __init__(self, path: str):
        self.members: List[FileArchive] = []
        base = os.path.dirname(os.path.abspath(path))
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                member = line if os.path.isabs(line) else os.path.join(base, line)
                self.members.append(FileArchive(member, "r"))

    def __contains__(self, name: str) -> bool:
        return any(name in m for m in self.members)

    def keys(self) -> List[str]:
        seen = []
        have = set()
        for m in self.members:
            for k in m.keys():
                if k not in have:
                    have.add(k)
                    seen.append(k)
        return seen

    def read(self, name: str) -> bytes:
        for m in self.members:
            if name in m:
                return m.read(name)
        raise KeyError(name)

    def close(self) -> None:
        for m in self.members:
            m.close()


def open_archive(path: str, mode: str = "r") -> object:
    """Open a file archive or bundle by extension."""
    if path.endswith(".bundle"):
        assert mode == "r", "bundles are read-only"
        return BundleArchive(path)
    return FileArchive(path, mode)


# ------------------------------------------------------------------ ndarray io
import numpy as np


def pack_ndarray(arr: "np.ndarray") -> bytes:
    """Self-describing little-endian ndarray encoding for cache entries."""
    arr = np.ascontiguousarray(arr)
    header = json.dumps({"dtype": arr.dtype.str, "shape": arr.shape}).encode()
    return struct.pack("<I", len(header)) + header + arr.tobytes()


def unpack_ndarray(data: bytes) -> "np.ndarray":
    (hlen,) = struct.unpack_from("<I", data, 0)
    meta = json.loads(data[4 : 4 + hlen].decode())
    arr = np.frombuffer(data, dtype=np.dtype(meta["dtype"]), offset=4 + hlen)
    return arr.reshape(meta["shape"])
