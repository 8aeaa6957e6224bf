"""Structured logging channels.

TPU-native replacement for the reference's channel/XML-log system
(ref: src/Core/Channel.{hh,cc}, src/Core/XmlStream.*): every component
resolves named channels (log / warning / error / statistics) to targets;
records are structured (JSONL) rather than XML, preserving the same
semantic fields (component, channel, per-segment records, timing).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, IO, Optional


class Channel:
    """A named output channel bound to a component."""

    def __init__(self, manager: "LogManager", component: str, kind: str):
        self._manager = manager
        self.component = component
        self.kind = kind

    def __call__(self, message: str = "", **fields: Any) -> None:
        self._manager.emit(self.component, self.kind, message, fields)

    # convenience for timing blocks
    def timed(self, name: str) -> "_TimedBlock":
        return _TimedBlock(self, name)


class _TimedBlock:
    def __init__(self, channel: Channel, name: str):
        self.channel = channel
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.channel(f"{self.name} done", elapsed_s=time.perf_counter() - self.t0)
        return False


class LogManager:
    """Process-wide sink registry. JSONL to file and/or human text to stderr."""

    _instance: Optional["LogManager"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._jsonl: Optional[IO[str]] = None
        self._stderr_level = int(os.environ.get("RASR_TPU_LOG_LEVEL", "1"))
        self._t0 = time.time()

    @classmethod
    def get(cls) -> "LogManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = LogManager()
            return cls._instance

    def open_jsonl(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._jsonl = open(path, "a", encoding="utf-8")

    def channel(self, component: str, kind: str) -> Channel:
        return Channel(self, component, kind)

    def emit(self, component: str, kind: str, message: str, fields: Dict[str, Any]) -> None:
        rec = {
            "t": round(time.time() - self._t0, 4),
            "component": component,
            "channel": kind,
        }
        if message:
            rec["msg"] = message
        rec.update(fields)
        if self._jsonl is not None:
            json.dump(rec, self._jsonl, default=str)
            self._jsonl.write("\n")
            self._jsonl.flush()
        level = {"error": 3, "warning": 2, "log": 1, "statistics": 0}.get(kind, 1)
        if level >= self._stderr_level:
            extra = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{kind}] {component}: {message} {extra}".rstrip(), file=sys.stderr)
