"""The conformer's work, forward and training step.

:func:`conformer_flop` is a copy of the port's
``models/nn.py::conformer_flop`` (the yardstick may not move with the
program): per frame of an utterance of T frames, the compute-dtype
operations (projections, feed-forwards, pointwise and depthwise
convolutions, ``Q K^T``) and the float32 ones (the attention weights
times the values). A training step is three forward passes' worth (the
backward is twice the forward), as the port's
``bench.py::train_step_flop`` counts it.
"""

from __future__ import annotations

import math
from typing import Sequence

from ..models.conformer import conformer_param_specs
from . import Work


def conformer_flop(cfg: dict, in_dim: int, classes: int, T: int):
    """(compute-dtype, float32) FLOP per frame of a forward pass over an
    utterance of ``T`` frames."""
    d, L, ff, k = cfg["d_model"], cfg["num_blocks"], cfg["ff_mult"], cfg["conv_kernel"]
    block = 2 * 2 * d * ff * d + 4 * d * d + d * 2 * d + d * d + d * k + T * d  # MACs
    return 2.0 * (in_dim * d + L * block + d * classes), 2.0 * L * T * d


def forward_work(lengths: Sequence[int], cfg: dict) -> Work:
    """Scoring each utterance at its own length: the conformer's products
    and the float32 attention, the parameters and features read and the
    scores written."""
    c = cfg["conformer"]
    D, M = cfg["frontend"]["feat_dim"], cfg["tying"]["num_classes"]
    lo = hi = 0.0
    for n in lengths:
        a, b = conformer_flop(c, D, M, int(n))
        lo += n * a
        hi += n * b
    N = float(sum(lengths))
    params = sum(math.prod(s) for _, s, _ in conformer_param_specs(cfg, D, M))
    return Work({"bf16": lo, "fp32": hi}, 4.0 * (params + N * (D + M)))


def train_step_work(batch: int, frames: int, cfg: dict) -> Work:
    """One training step on ``batch`` x ``frames``: three forward passes."""
    c = cfg["conformer"]
    a, b = conformer_flop(c, cfg["frontend"]["feat_dim"], cfg["tying"]["num_classes"], frames)
    n = 3.0 * batch * frames
    return Work({"bf16": n * a, "fp32": n * b})
