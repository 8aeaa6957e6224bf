"""The conformer acoustic model and its hybrid scores, in plain PyTorch.

One utterance at a time (no padding, no masks), float32 by default with
TF32 off. Each block: half feed-forward (LayerNorm, linear, swish,
linear), self-attention over the utterance (LayerNorm, 8 heads, softmax),
the convolution module (LayerNorm, linear to 2d, GLU, depthwise conv over
time with "same" padding, LayerNorm, swish, linear), half feed-forward,
final LayerNorm; each part residual. Absolute sinusoidal positions follow
the input projection. Scores are ``scale * (-log softmax + prior_scale *
log prior)``.

``quant`` rounds every matrix product's operands (and the depthwise
convolution's) to a narrower type first: the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def _no_tf32():
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    return saved


def _restore(saved):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def positions(T: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(T, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float64, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2.0 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d].float()


def logits(x: torch.Tensor, w: dict, cfg: dict,
           quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """``x [T, in_dim]`` float32 -> ``[T, classes]`` logits."""
    c = cfg["conformer"]
    q = quant or (lambda t: t)
    H = c["num_heads"]

    def lin(name, h):
        return q(h) @ q(w[name + ".weight"]).T + w[name + ".bias"]

    def ln(name, h):
        return F.layer_norm(h, h.shape[-1:], w[name + ".weight"], w[name + ".bias"], LN_EPS)

    def swish(h):
        return h * torch.sigmoid(h)

    saved = _no_tf32()
    try:
        T = x.shape[0]
        h = lin("input_proj", x) + positions(T, c["d_model"], x.device)
        for i in range(c["num_blocks"]):
            p = f"block.{i}."
            h = h + 0.5 * lin(p + "ff1_out", swish(lin(p + "ff1_in", ln(p + "ff1_ln", h))))
            a = ln(p + "mhsa_ln", h)
            qh, kh, vh = (lin(p + "mhsa." + n, a).view(T, H, -1).transpose(0, 1)
                          for n in ("query", "key", "value"))
            att = torch.softmax(q(qh) @ q(kh).transpose(1, 2) / math.sqrt(qh.shape[-1]), dim=-1)
            ctx = (q(att) @ q(vh)).transpose(0, 1).reshape(T, -1)
            h = h + lin(p + "mhsa.out", ctx)
            g = lin(p + "conv_in", ln(p + "conv_ln", h))
            g = g[:, : g.shape[1] // 2] * torch.sigmoid(g[:, g.shape[1] // 2:])
            kw = w[p + "conv_dw.weight"]  # [d, 1, k]
            k = kw.shape[-1]
            g = F.pad(q(g).T[None], ((k - 1) // 2, k // 2))
            g = F.conv1d(g, q(kw), groups=kw.shape[0])[0].T + w[p + "conv_dw.bias"]
            h = h + lin(p + "conv_out", swish(ln(p + "conv_bn", g)))
            h = h + 0.5 * lin(p + "ff2_out", swish(lin(p + "ff2_in", ln(p + "ff2_ln", h))))
            h = ln(p + "final_ln", h)
        return lin("output", h)
    finally:
        _restore(saved)


def scores(x: torch.Tensor, w: dict, log_priors: torch.Tensor, cfg: dict, quant=None) -> torch.Tensor:
    """``x [T, in_dim]`` -> ``[T, classes]`` hybrid emission scores."""
    c = cfg["conformer"]
    logp = torch.log_softmax(logits(x, w, cfg, quant).double(), dim=-1)
    return c["scale"] * (-(logp - c["prior_scale"] * log_priors.double()))


def log_priors(counts, device) -> torch.Tensor:
    """Smoothed relative-frequency log priors of class counts (add one)."""
    c = torch.as_tensor(counts, dtype=torch.float64, device=device) + 1.0
    return torch.log(c / c.sum())
