"""Rounding to narrower number formats, for the lower-precision controls.

A TF32 or bf16 tensor-core product rounds its float32 operands to 10 or 7
mantissa bits and accumulates in float32; fp8 (e4m3) rounds to 3 bits
under a per-tensor scale. Rounding the operands and multiplying in
float32 reproduces that arithmetic on any device. A float32 sum outside
the products (a path's running score) goes one step down to bfloat16
(:func:`bf16_round`).
"""

from __future__ import annotations

import torch


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` (float32) rounded to nearest, ties away, at ``bits`` mantissa bits."""
    x = x.float().contiguous()
    i = x.view(torch.int32)
    drop = 23 - bits
    r = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return r.view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    return round_mantissa(x, 10)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor."""
    x = x.float()
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


QUANT = {"tf32": tf32, "fp8": fp8}


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """A float64 sum rounded to bfloat16 (kept as float64)."""
    return x.to(torch.bfloat16).double()
