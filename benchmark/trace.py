"""Spans around the port's layers, and the device trace read against them.

The harness wraps each call into a layer in a ``torch.profiler``
``record_function`` span named after the layer (:func:`span`). In a
traced run, :func:`profiled` records a sub-window of whole batches or
steps, and :func:`summarize` reads the profiler's events: every kernel,
copy and fill on the device is matched to the host call that launched it
through the profiler's correlation ids, and so to the span the host was
in; a layer's device time is the sum of what its span launched, whatever
the kernels are named. Idle gaps on the device are attributed to the span
and the host operation running at their midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

def sync() -> None:
    """Wait for the card, where there is one."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def span(name: str):
    """A span around one call into the layer ``name``."""
    return record_function(name)


@contextlib.contextmanager
def profiled():
    """Records host and device activity for its duration; yields the
    profiler (read it with :func:`summarize` after the block)."""
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts, record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        yield prof
        sync()


@dataclasses.dataclass
class SpanStats:
    device_s: float = 0.0  # kernels, copies and fills launched inside the span
    kernels: int = 0  # kernel launches inside the span
    calls: int = 0  # times the span was entered


@dataclasses.dataclass
class Summary:
    spans: Dict[str, SpanStats]
    busy_s: float  # union of device activity
    window_s: float  # from the first span's start to the last device event's end
    device_ops: List[Tuple[str, float]]  # the ten device operations that took longest, summed
    idle_gaps: List[Tuple[str, float]]  # idle seconds by what the host was doing, top ten
    unmatched: int  # device events whose launch was not found

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s > 0 else float("nan")


def _device_kind(name: str) -> str:
    """What a device event is, from its name (the profiler's event objects
    carry no activity type on every PyTorch release)."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def summarize(prof, names) -> Summary:
    """Reduce a :func:`profiled` recording to per-span device time and
    launches, device busy time, the longest device operations and the idle
    gaps by host activity. ``names`` are the span names to attribute to.

    A device event links to the host event that launched it: its
    ``linked_correlation_id`` names a host operation or span (as
    ``torch.profiler`` links them), else its ``correlation_id`` names the
    runtime call that launched it (``cudaLaunchKernel`` and the like)."""
    names = set(names)
    spans: List[Tuple[int, int, str]] = []  # (start, end, name) of the layer spans
    ops: Dict[int, int] = {}  # correlation id of a host operation or span -> its start
    runtime: Dict[int, int] = {}  # correlation id of a CUDA runtime or driver call -> its start
    host: List[Tuple[int, int, str]] = []  # host calls, for idle attribution
    dev: List[Tuple[int, int, str, int, int, str]] = []  # start, end, name, corr, linked, kind
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in names:  # the device-side copies of the spans are not work
                dev.append((start, end, name, e.correlation_id(), e.linked_correlation_id(),
                            _device_kind(name)))
            continue
        (runtime if name.startswith("cu") else ops)[e.correlation_id()] = start
        if name in names:
            spans.append((start, end, name))
        else:
            host.append((start, end, name))
    spans.sort()
    host.sort()
    dev.sort()
    starts = [s[0] for s in spans]

    def span_at(t: int) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else None

    stats = {n: SpanStats() for n in names}
    for _, _, n in spans:
        stats[n].calls += 1
    by_op: Dict[str, float] = {}
    unmatched = 0
    for start, end, name, corr, linked, kind in dev:
        t = ops.get(linked) if linked else None
        t = runtime.get(corr) if t is None else t
        if t is None:
            unmatched += 1
            continue
        n = span_at(t)
        if n is not None:
            stats[n].device_s += (end - start) * 1e-9
            stats[n].kernels += kind == "kernel"
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (end - start) * 1e-9
    # the union of device activity, and the gaps between
    lo = spans[0][0] if spans else (dev[0][0] if dev else 0)
    hi = max([s[1] for s in spans] + [d[1] for d in dev]) if (spans or dev) else lo
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for start, end, *_ in dev:
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, start))
            else:
                gaps.append((lo, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, hi))
    host_starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) // 2
        op = "none"
        i = bisect.bisect_right(host_starts, mid) - 1
        for j in range(i, max(i - 200, -1), -1):  # the innermost host call over mid
            if host[j][1] >= mid:
                op = host[j][2]
                break
        key = f"{span_at(mid) or 'outside'}:{op[:80]}"
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-9
    if unmatched:
        print(f"[trace] {unmatched} of {len(dev)} device events without a launch", file=sys.stderr)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return Summary(stats, busy * 1e-9, (hi - lo) * 1e-9, top,
                   sorted(idle.items(), key=lambda kv: -kv[1])[:10], unmatched)
