"""Profiling: the program's span recorder, ``torch.profiler`` traces and
per-op self-time tables.

The port's counterpart of ``rasr_tpu/utils/profiling.py``, with its
signatures: :func:`trace` captures a trace into a directory,
:func:`profile_call` runs a callable under it and returns per-op
self-time rows sorted by cost, :func:`top_table` formats them. The rows
come from the profiler's own events, not from xprof. On a card they are
the device's kernels and copies (category ``"cuda"``, summed by name); on
the CPU, where there is no device activity, they are the host ops of
``key_averages()`` (category ``"cpu"``).

:class:`Recorder` keeps the program's own spans and counts: where each
layer spends host time, by name (``decode.dispatch``, ``align.viterbi``,
...), stamped on ``torch.profiler``'s clock (the Unix epoch, in ns) so
that a device trace and the spans line up. A span lives in memory only:
it never becomes a ``record_function`` or NVTX range, so it adds nothing
to a device trace and no kernel, copy or sync to the path it times. Its
counts are values the host knows (shapes, trip counts), never a device
value. :data:`RECORDER` is the process's recorder: the layers record
into it and a benchmark's readers read it (:func:`records`), neither
holding the other.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from .statistics import Accumulator

#: spans kept per name (the oldest go first); the accumulators count every span
BOUND = 8192
#: the Chrome-trace thread the program's spans are drawn on
SPANS_TID = 0x5350


def profiler_recording() -> bool:
    """Whether a ``torch.profiler`` (or ``torch.autograd.profiler``) is recording."""
    return torch.autograd.profiler._is_profiler_enabled


class Span:
    """One program span: ``name``, ``start_ns`` and ``end_ns`` on the
    profiler's clock, ``parent`` (the enclosing span's ``id``, or None),
    ``call`` (the outermost enclosing span's ``id``: every span of one call
    into a layer shares it), ``profiled`` (a ``torch.profiler`` recorded at
    its start) and ``counts`` (host-known values). Entered as a context
    manager (:meth:`Recorder.span`), it times the block."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns", "profiled", "counts",
                 "_rec")

    def __init__(self, rec: Optional["Recorder"], name: str, counts: Optional[dict] = None):
        self._rec, self.name, self.counts = rec, name, counts or {}
        self.id = self.parent = self.call = None
        self.start_ns = self.end_ns = 0
        self.profiled = False

    def __enter__(self) -> "Span":
        self._rec._open(self)
        self.start_ns = time.perf_counter_ns() + self._rec.offset_ns
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns() + self._rec.offset_ns
        self._rec._close(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, call={self.call}, "
                f"{(self.end_ns - self.start_ns) / 1e3:.1f} us, counts={self.counts})")


class Recorder:
    """The program's spans, kept in memory: the last ``bound`` of each
    name, and a running :class:`~.statistics.Accumulator` of each name's
    durations in microseconds over all of them.

    The clock is ``time.perf_counter_ns`` moved onto the Unix epoch (the
    profiler's time base) by one offset taken when the recorder starts, so
    a step of the wall clock cannot move a span. Spans nest per thread."""

    def __init__(self, bound: int = BOUND):
        self.bound = bound
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._kept: Dict[str, Deque[Span]] = {}
        self._acc: Dict[str, Accumulator] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._marked: List[tuple] = []  # add_marked's passes, made into spans when read

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, sp: Span) -> None:
        stack = self._stack()
        parent = stack[-1] if stack else None
        sp.id = next(self._ids)
        sp.parent = parent.id if parent is not None else None
        sp.call = parent.call if parent is not None else sp.id
        sp.profiled = profiler_recording()
        stack.append(sp)

    def _close(self, sp: Span) -> None:
        self._stack().remove(sp)
        sp._rec = None
        self._keep(sp)

    def _keep(self, sp: Span) -> None:
        kept = self._kept.get(sp.name)
        if kept is None:
            kept = self._kept.setdefault(sp.name, deque(maxlen=self.bound))
            self._acc.setdefault(sp.name, Accumulator(sp.name))
        kept.append(sp)
        self._acc[sp.name].add((sp.end_ns - sp.start_ns) / 1e3)

    def now_ns(self) -> int:
        """Now, on the recorder's (the profiler's) clock."""
        return time.perf_counter_ns() + self.offset_ns

    def span(self, name: str, **counts) -> Span:
        """A span over a ``with`` block, child of the innermost open span of
        this thread; ``counts`` are host-known values."""
        return Span(self, name, counts)

    def add_marked(self, name: str, phases: Sequence[str], stamps: Sequence[int]) -> None:
        """Record phase marks: ``stamps`` holds ``time.perf_counter_ns`` at a
        start, then at the end of each of ``phases``, pass after pass (a
        pass starts where the one before ended). Each whole pass becomes one
        span ``name`` under the innermost open span, with a child span
        ``name.<phase>`` per phase. The spans are made when they are next
        read, so marking costs its caller one append."""
        stack = self._stack()
        self._marked.append((name, tuple(phases), stamps, stack[-1] if stack else None,
                             profiler_recording()))

    def _make_marked(self) -> None:
        off = self.offset_ns
        while self._marked:
            name, phases, stamps, parent, profiled = self._marked.pop(0)
            children = [f"{name}.{phase}" for phase in phases]
            n = len(children)

            def keep(span_name, parent_id, call, a, b):
                sp = Span(None, span_name)
                sp.id = next(self._ids)
                sp.parent, sp.call, sp.profiled = parent_id, call or sp.id, profiled
                sp.start_ns, sp.end_ns = stamps[a] + off, stamps[b] + off
                self._keep(sp)
                return sp

            for k in range(0, len(stamps) - n, n):
                step = keep(name, parent and parent.id, parent and parent.call, k, k + n)
                for i, child in enumerate(children):
                    keep(child, step.id, step.call, k + i, k + i + 1)

    def records(self, name: str) -> List[Span]:
        """The kept spans of ``name``, oldest first."""
        self._make_marked()
        return list(self._kept.get(name, ()))

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per span name, its accumulator's report (microseconds) over every
        span of the name, kept or not."""
        self._make_marked()
        return {name: self._acc[name].report() for name in sorted(self._acc)}

    def export_chrome(self, path: str, base_ns: int = 0, since_ns: int = 0) -> int:
        """Write the kept spans that start at or after ``since_ns`` to
        ``path`` as Chrome-trace ``"X"`` events on the profiler's clock
        (``ts`` in microseconds after ``base_ns``, a profiler trace's
        ``baseTimeNanoseconds``), on a thread of their own; returns how
        many were written."""
        self._make_marked()
        pid = os.getpid()
        events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPANS_TID,
                   "args": {"name": "program spans"}}]
        spans = sorted((sp for kept in self._kept.values() for sp in kept
                        if sp.start_ns >= since_ns), key=lambda sp: (sp.start_ns, -sp.end_ns))
        for sp in spans:
            events.append({"ph": "X", "cat": "program", "name": sp.name, "pid": pid,
                           "tid": SPANS_TID, "ts": (sp.start_ns - base_ns) / 1e3,
                           "dur": (sp.end_ns - sp.start_ns) / 1e3,
                           "args": dict(sp.counts, id=sp.id, parent=sp.parent, call=sp.call)})
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns,
                       "displayTimeUnit": "ms"}, fh)
        return len(spans)


#: the process's recorder (the layers record here; a benchmark reads it)
RECORDER = Recorder()


def span(name: str, **counts) -> Span:
    """:meth:`Recorder.span` of :data:`RECORDER`."""
    return RECORDER.span(name, **counts)


def spanned(name: str) -> Callable[[Callable], Callable]:
    """Decorator: every call of the function in a span ``name`` of
    :data:`RECORDER`."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with RECORDER.span(name):
                return fn(*args, **kwargs)
        return call
    return deco


def records(name: str) -> List[Span]:
    """:meth:`Recorder.records` of :data:`RECORDER`."""
    return RECORDER.records(name)


def report() -> Dict[str, Dict[str, float]]:
    """:meth:`Recorder.report` of :data:`RECORDER`."""
    return RECORDER.report()


def _activities() -> List[ProfilerActivity]:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Context manager: profile the block and write its Chrome trace to
    ``log_dir/trace.json``, and beside it ``log_dir/spans.json``: the
    program spans that started in the block, on the trace's time base.
    Yields the ``torch.profiler.profile``. :func:`merge_chrome` joins the
    two files into one."""
    os.makedirs(log_dir, exist_ok=True)
    since = RECORDER.now_ns()
    with profile(activities=_activities()) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        base = int(json.load(fh).get("baseTimeNanoseconds", 0))
    RECORDER.export_chrome(os.path.join(log_dir, "spans.json"), base, since)


def merge_chrome(log_dir: str) -> str:
    """Join :func:`trace`'s ``trace.json`` and ``spans.json`` into
    ``log_dir/merged.json``, the program spans on a row of their own over
    the profiler's host and device rows; returns its path."""
    with open(os.path.join(log_dir, "trace.json")) as fh:
        merged = json.load(fh)
    with open(os.path.join(log_dir, "spans.json")) as fh:
        merged["traceEvents"] += json.load(fh)["traceEvents"]
    out = os.path.join(log_dir, "merged.json")
    with open(out, "w") as fh:
        json.dump(merged, fh)
    return out


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
