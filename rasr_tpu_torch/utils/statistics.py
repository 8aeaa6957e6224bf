"""Statistics accumulators, histograms and timers.

Mirrors the reference's per-component statistics machinery
(ref: src/Core/Statistics.*, src/Core/Timer.*): counters, running
min/max/mean/variance accumulators, fixed-bin histograms, and wall-clock
timers — flushed as structured records through the logging channels.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional


class Accumulator:
    """Running count/sum/sumsq/min/max of a scalar series."""

    def __init__(self, name: str = ""):
        self.name = name
        self.clear()

    def clear(self) -> None:
        self.n = 0
        self.sum = 0.0
        self.sumsq = 0.0
        self.min = math.inf
        self.max = -math.inf

    def __iadd__(self, value: float) -> "Accumulator":
        self.add(value)
        return self

    def add(self, value: float, weight: float = 1.0) -> None:
        self.n += 1
        self.sum += weight * value
        self.sumsq += weight * value * value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def merge(self, other: "Accumulator") -> None:
        self.n += other.n
        self.sum += other.sum
        self.sumsq += other.sumsq
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    @property
    def variance(self) -> float:
        if not self.n:
            return 0.0
        return max(0.0, self.sumsq / self.n - self.mean**2)

    def report(self) -> Dict[str, float]:
        return {
            "n": self.n,
            "mean": self.mean,
            "std": math.sqrt(self.variance),
            "min": self.min if self.n else 0.0,
            "max": self.max if self.n else 0.0,
            "sum": self.sum,
        }


class Histogram:
    """Fixed-width binned histogram over [lo, hi)."""

    def __init__(self, lo: float, hi: float, bins: int = 32, name: str = ""):
        self.lo, self.hi, self.bins = lo, hi, bins
        self.name = name
        self.counts = [0] * bins
        self.under = 0
        self.over = 0

    def add(self, value: float) -> None:
        if value < self.lo:
            self.under += 1
        elif value >= self.hi:
            self.over += 1
        else:
            idx = int((value - self.lo) / (self.hi - self.lo) * self.bins)
            self.counts[min(idx, self.bins - 1)] += 1

    def quantile(self, q: float) -> float:
        total = sum(self.counts) + self.under + self.over
        if total == 0:
            return self.lo
        target = q * total
        seen = self.under
        width = (self.hi - self.lo) / self.bins
        for i, c in enumerate(self.counts):
            if seen + c >= target:
                return self.lo + (i + 0.5) * width
            seen += c
        return self.hi

    def report(self) -> Dict[str, object]:
        return {"counts": list(self.counts), "under": self.under, "over": self.over}


class Timer:
    """Wall-clock timer (ref: Core::Timer)."""

    def __init__(self) -> None:
        self._start: Optional[float] = None
        self.elapsed = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._start is not None:
            self.elapsed += time.perf_counter() - self._start
            self._start = None
        return self.elapsed

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


class StatisticsRegistry:
    """Grouped accumulators with a single flush point."""

    def __init__(self) -> None:
        self._acc: Dict[str, Accumulator] = {}
        self._hist: Dict[str, Histogram] = {}

    def accumulator(self, name: str) -> Accumulator:
        if name not in self._acc:
            self._acc[name] = Accumulator(name)
        return self._acc[name]

    def histogram(self, name: str, lo: float, hi: float, bins: int = 32) -> Histogram:
        if name not in self._hist:
            self._hist[name] = Histogram(lo, hi, bins, name)
        return self._hist[name]

    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for name, acc in self._acc.items():
            out[name] = acc.report()
        for name, hist in self._hist.items():
            out[name] = hist.report()
        return out
