"""Work counts: the operations and bytes the inputs need, whatever computes them.

A count is ``Work(flop={precision: operations}, nbytes=...)``. Each input
byte is read once and each output byte written once; only real frames
count, never padding. Precisions are priced at one NVIDIA H100 SXM's
published dense peaks (NVIDIA's data sheet, 700 W): ``bf16`` at 989
TFLOP/s, ``tf32x3`` (float32-accurate products on the tensor cores as
three TF32 products) at 495 TFLOP/s with the three products counted,
``fp32`` (float32 outside the tensor cores) at 67 TFLOP/s, and HBM at
3.35 TB/s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = {"bf16": 989e12, "tf32x3": 495e12 / 3.0, "fp32": 67e12}
HBM_BYTES_S = 3.35e12


@dataclasses.dataclass
class Work:
    flop: Dict[str, float] = dataclasses.field(default_factory=dict)
    nbytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        flop = dict(self.flop)
        for k, v in other.flop.items():
            flop[k] = flop.get(k, 0.0) + v
        return Work(flop, self.nbytes + other.nbytes)

    def op_seconds(self) -> float:
        """The operations' least time: each precision at its own peak, summed."""
        return sum(v / PEAK_FLOPS[k] for k, v in self.flop.items())

    def least_seconds(self) -> float:
        """The larger of the operations' and the bytes' least time."""
        return max(self.op_seconds(), self.nbytes / HBM_BYTES_S)
