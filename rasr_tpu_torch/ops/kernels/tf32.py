"""The 3xTF32 split of fp32 operands, as the tensor-core kernels take it.

A TF32 value is an fp32 value whose low 13 mantissa bits are zero. An
fp32 operand ``x`` splits into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
(round to nearest, ties away from zero: PTX ``cvt.rna.tf32.f32``). A
product then runs as ``hi*hi + hi*lo + lo*hi`` on the tensor cores with
fp32 accumulation: each partial product of two TF32 values is exact in
fp32, and the dropped ``lo*lo`` term is below 2^-22 of ``|a*b|``, which
is the accuracy of an fp32 product (``csrc/tf32x3.cuh`` is the device
side of the same split).
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """fp32 ``x`` -> ``(hi, lo)``, both TF32, with ``hi + lo`` ~= ``x``."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)
