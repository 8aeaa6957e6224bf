"""Profiling: ``torch.profiler`` traces and per-op self-time tables.

The port's counterpart of ``rasr_tpu/utils/profiling.py``, with its
signatures: :func:`trace` captures a trace into a directory,
:func:`profile_call` runs a callable under it and returns per-op
self-time rows sorted by cost, :func:`top_table` formats them. The rows
come from the profiler's own events, not from xprof. On a card they are
the device's kernels and copies (category ``"cuda"``, summed by name); on
the CPU, where there is no device activity, they are the host ops of
``key_averages()`` (category ``"cpu"``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile


def _activities() -> List[ProfilerActivity]:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Context manager: profile the block and write its Chrome trace to
    ``log_dir/trace.json``; yields the ``torch.profiler.profile``."""
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def op_rows(prof: profile) -> List[Dict[str, Any]]:
    """Per-op rows (``name``, ``category``, ``occurrences``,
    ``self_time_us``; ``program`` is empty) sorted by self time, descending."""
    device = defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            row = device[ev.name]
            row[0] += 1
            row[1] += ev.time_range.elapsed_us()
    if device:
        rows = [{"program": "", "name": name, "category": "cuda", "occurrences": n,
                 "self_time_us": float(us)} for name, (n, us) in device.items()]
    else:
        rows = [{"program": "", "name": ev.key, "category": "cpu", "occurrences": ev.count,
                 "self_time_us": float(ev.self_cpu_time_total)}
                for ev in prof.key_averages()]
    rows.sort(key=lambda r: -r["self_time_us"])
    return rows


def profile_call(
    fn: Callable, *args, log_dir: Optional[str] = None, warmup: int = 1, **kwargs,
) -> Tuple[Any, List[Dict[str, Any]]]:
    """Run ``fn(*args)`` under a trace (after ``warmup`` untraced calls,
    so one-time set-up stays out of the profile) -> (result, op rows)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    tmp = log_dir or tempfile.mkdtemp(prefix="rasr_tpu_torch_prof_")
    with trace(tmp) as prof:
        out = fn(*args, **kwargs)
        _sync()
    return out, op_rows(prof)


def top_table(rows: List[Dict[str, Any]], n: int = 15) -> str:
    """Human-readable top-N self-time table (for log channels)."""
    lines = [f"{'self us':>10}  {'category':<18} name"]
    for r in rows[:n]:
        lines.append(f"{r['self_time_us']:>10.1f}  {str(r['category']):<18} {r['name']}")
    return "\n".join(lines)
