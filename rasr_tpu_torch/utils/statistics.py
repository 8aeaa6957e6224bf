"""Statistics accumulators.

Mirrors the reference's running min/max/mean/variance accumulators
(ref: src/Core/Statistics.*), flushed as structured records through the
logging channels. Timing, and the accumulators grouped per name, are the
span recorder's (``utils/profiling.py``).
"""

from __future__ import annotations

import math
from typing import Dict


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
