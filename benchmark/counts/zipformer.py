"""The Zipformer's work, forward and training step, by frame rate.

Per utterance of T frames at 100 Hz (``T' = T // 2`` at 50 Hz, ``T_k =
ceil(T' / ds_k)`` in stack k), the multiply-adds of what the plain
reference computes, counted apart:

- ``embed``: the 2-D convolutions, the ConvNeXt and the Linear (bf16);
- ``stacks``: per stack, its layers' linear layers, depthwise
  convolutions, ``Q K^T``, the position scores (``p . W_pos e``, one offset
  per pair of frames) and ``W_pos`` over the ``2 T_k - 1`` offsets (bf16);
- ``attention``: the attention weights times the values (the non-linear
  attention's and both self-attentions'), float32;
- ``head``: the transposed convolution and the output Linear (bf16).

Elementwise work (activations, norms, bypasses, softmaxes, the
downsampling sums) is not counted. A training step is three forward
passes' worth (the backward is twice the forward), as the conformer's.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

from ..models.zipformer import CONVNEXT_HIDDEN, EMBED_CHANNELS, zipformer_param_specs
from . import Work


def forward_macs(cfg: dict, in_dim: int, classes: int, T: int) -> Dict[str, object]:
    """Multiply-adds of one forward pass over an utterance of ``T``
    frames: ``embed``, ``stacks`` (a list, one a stack), ``attention``
    (float32) and ``head``."""
    z = cfg["zipformer"]
    qd, vd, pd, pos_dim = z["query_head_dim"], z["value_head_dim"], z["pos_head_dim"], z["pos_dim"]
    (c1, c2, c3), hid = EMBED_CHANNELS, CONVNEXT_HIDDEN
    T2 = T // 2
    t0 = T + 5  # conv0's frames of T + 7
    t1 = (t0 - 3) // 2 + 1
    f1 = (in_dim - 3) // 2 + 1
    f2 = (f1 - 3) // 2 + 1
    d0 = z["encoder_dim"][0]
    embed = (c1 * t0 * in_dim * 9 + c2 * t1 * f1 * c1 * 9 + c3 * T2 * f2 * c2 * 9
             + c3 * T2 * f2 * (49 + 2 * hid) + T2 * c3 * f2 * d0)
    stacks, attention = [], 0
    for ds, n, d, ff, H, k in zip(z["downsampling_factor"], z["num_encoder_layers"],
                                  z["encoder_dim"], z["feedforward_dim"], z["num_heads"],
                                  z["cnn_module_kernel"]):
        Tk = -(-T2 // ds)
        per_frame = (d * H * (2 * qd + pd)  # Q, K, p
                     + H * Tk * (qd + pd)  # Q K^T and the position scores
                     + 2 * d * (3 * ff // 4 + ff + 5 * ff // 4)  # three feed-forwards
                     + d * 3 * (3 * d // 4) + (3 * d // 4) * d  # NLA's projections
                     + 2 * 2 * d * H * vd  # two self-attentions' projections
                     + 2 * (2 * d * d + d * k + d * d))  # two convolution modules
        stacks.append(n * (Tk * per_frame + (2 * Tk - 1) * pos_dim * H * pd))
        attention += n * Tk * Tk * (3 * d // 4 + 2 * H * vd)
    W = max(z["encoder_dim"])
    head = T * W * W + T * W * classes
    return {"embed": embed, "stacks": stacks, "attention": attention, "head": head}


def forward_flop(cfg: dict, in_dim: int, classes: int, T: int):
    """(bf16, float32) FLOP of one forward pass over ``T`` frames."""
    m = forward_macs(cfg, in_dim, classes, T)
    return 2.0 * (m["embed"] + sum(m["stacks"]) + m["head"]), 2.0 * m["attention"]


def forward_work(lengths: Sequence[int], cfg: dict) -> Work:
    """Scoring each utterance at its own length: the products, the
    parameters and features read and the scores written."""
    D, M = cfg["frontend"]["feat_dim"], cfg["tying"]["num_classes"]
    lo = hi = 0.0
    for n in lengths:
        a, b = forward_flop(cfg, D, M, int(n))
        lo += a
        hi += b
    N = float(sum(lengths))
    params = sum(math.prod(s) for _, s, _ in zipformer_param_specs(cfg, D, M))
    return Work({"bf16": lo, "fp32": hi}, 4.0 * (params + N * (D + M)))


def train_step_work(batch: int, frames: int, cfg: dict) -> Work:
    """One training step on ``batch`` x ``frames``: three forward passes."""
    a, b = forward_flop(cfg, cfg["frontend"]["feat_dim"], cfg["tying"]["num_classes"], frames)
    return Work({"bf16": 3.0 * batch * a, "fp32": 3.0 * batch * b})
