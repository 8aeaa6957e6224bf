"""The Zipformer hybrid acoustic model and its scores, in plain PyTorch.

Zipformer-L (Yao et al., ICLR 2024; icefall's large recipe) with a
hybrid head, one utterance at a time (no padding, no masks), float32
with TF32 off. ``x [T, D]`` at 100 Hz:

- embedding: 7 zero frames appended; Conv2d(1 -> 8, 3x3, padding (0, 1)),
  SwooshR; Conv2d(8 -> 32, 3x3, stride 2), SwooshR; Conv2d(32 -> 128,
  3x3, stride (1, 2)), SwooshR; ConvNeXt (7x7 depthwise, padding 3; 1x1 to
  384; SwooshL; 1x1 to 128; residual); channels x frequencies flattened,
  Linear, BiasNorm: ``T // 2`` frames at 50 Hz.
- six stacks (ds, layers, d, F, H, kernel) = (1, 2, 192, 512, 4, 31),
  (2, 2, 256, 768, 4, 31), (4, 4, 512, 1536, 4, 15), (8, 5, 768, 2048, 8,
  15), (4, 4, 512, 1536, 4, 15), (2, 2, 256, 768, 4, 31); a stack's input
  is the last output with its channels zero-padded or cut to d. With ds >
  1: ``x0 = x``; the time padded with the last frame to a multiple of ds
  and each group summed with weights ``softmax(w)``; the layers; each
  frame repeated ds times and cropped; ``x = x0 + c_out (x - x0)``.
- a layer: attention weights ``A_h = softmax_j(Q_h,i . K_h,j + p_h,i .
  W_pos e(j - i))`` from its input x0 (Q, K 32 dims, p 4 dims per head, no
  scale; e the compact encoding below); then ``x += FF1``, ``x += NLA(x,
  A_0)``, ``x += SA1(x, A)``, ``x += Conv1``, ``x += FF2``, ``x = x0 + c_mid
  (x - x0)``, ``x += SA2(x, A)``, ``x += Conv2``, ``x += FF3``, ``x =
  BiasNorm(x)``, ``x = x0 + c (x - x0)``. ``FFn = W2 SwooshL(W1 x)`` with
  hidden 3F/4, F, 5F/4; ``NLA = W_out((A_0 (tanh(s) u)) v)`` with ``[s, u,
  v] = W_in x`` (3d/4 each); ``SA = W_o concat_h(A_h W_v,h x)`` (12 dims a
  head); ``Conv = W_out SwooshR(depthwise(a sigmoid(g)))`` with ``[a, g] =
  W_in x``, kernel k, same padding; ``BiasNorm(x) = x exp(gamma)
  mean_c((x - b)^2)^(-1/2)``.
- ``SwooshR(z) = log(1 + e^(z-1)) - 0.08 z - 0.313261687``, ``SwooshL(z) =
  log(1 + e^(z-4)) - 0.08 z - 0.035``.
- ``e(delta)``, 48 dims, ``L = sqrt(48)``: ``delta' = L sign(delta)
  (log(|delta| + L) - log L)``, ``theta = atan(delta' 2 pi / 48)``,
  ``e[2m] = cos((m+1) theta)``, ``e[2m+1] = sin((m+1) theta)``, ``e[47] =
  1``.
- output: stack 5's 256 channels, stack 4's channels 256-511, stack 3's
  512-767; Down by 2 (25 Hz).
- hybrid head: ``ceil(T / 4)`` frames (the last repeated where the
  encoder gives fewer), a transposed convolution (kernel and stride 4),
  cropped to T, a Linear to the classes.

Departures from icefall: the 45-dim input (a 1,280-input Linear), the
hybrid head in place of the transducer's, and no training-only module
(Balancer, Whiten, ScaleGrad, skip and dropout rates). Scores are
``scale * (-log softmax + prior_scale * log prior)``.

``quant`` rounds every product's operands (linear layers, convolutions,
the attention scores and the weights times the values) to a narrower type
first: the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .conformer import _no_tf32, _restore, log_priors  # noqa: F401  (log_priors: the scores')


def swoosh_r(z):
    return torch.log(1.0 + torch.exp(z - 1.0)) - 0.08 * z - 0.313261687


def swoosh_l(z):
    return torch.log(1.0 + torch.exp(z - 4.0)) - 0.08 * z - 0.035


def encoding(delta: torch.Tensor, dim: int) -> torch.Tensor:
    """The compact relative encoding ``[len(delta), dim]`` of the offsets."""
    delta = delta.double()
    L = math.sqrt(dim)
    comp = L * torch.sign(delta) * (torch.log(delta.abs() + L) - math.log(L))
    theta = torch.atan(comp * 2.0 * math.pi / dim)
    e = torch.zeros(len(delta), dim, dtype=torch.float64, device=delta.device)
    for m in range(dim // 2):
        e[:, 2 * m] = torch.cos((m + 1) * theta)
        e[:, 2 * m + 1] = torch.sin((m + 1) * theta)
    e[:, dim - 1] = 1.0
    return e.float()


def logits(x: torch.Tensor, w: dict, cfg: dict,
           quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """``x [T, in_dim]`` float32 -> ``[T, classes]`` logits."""
    z = cfg["zipformer"]
    q = quant or (lambda t: t)
    qd, vd, pd, pos_dim = z["query_head_dim"], z["value_head_dim"], z["pos_head_dim"], z["pos_dim"]

    def lin(name, h):
        y = q(h) @ q(w[name + ".weight"]).T
        return y + w[name + ".bias"] if name + ".bias" in w else y

    def conv2d(name, h, stride=1, padding=0, groups=1):
        return F.conv2d(q(h), q(w[name + ".weight"]), w[name + ".bias"], stride, padding,
                        groups=groups)

    def bias_norm(name, h):
        return h * torch.mean((h - w[name + ".bias"]) ** 2, dim=-1, keepdim=True) ** -0.5 \
            * torch.exp(w[name + ".log_scale"])

    def bypass(name, x0, h):
        return x0 + w[name + ".scale"] * (h - x0)

    def down(name, h, ds):
        n = -(-h.shape[0] // ds)
        h = torch.cat([h, h[-1:].expand(n * ds - h.shape[0], -1)])
        return (h.view(n, ds, -1) * torch.softmax(w[name + ".weights"], 0)[:, None]).sum(1)

    def layer(p, x, H, k):
        T = x.shape[0]
        x0 = x
        qkp = lin(p + "self_attn_weights.in_proj", x)
        qh = qkp[:, : H * qd].view(T, H, qd).transpose(0, 1)
        kh = qkp[:, H * qd: 2 * H * qd].view(T, H, qd).transpose(0, 1)
        ph = qkp[:, 2 * H * qd:].view(T, H, pd).transpose(0, 1)
        i = torch.arange(T, device=x.device)
        rel = lin(p + "self_attn_weights.linear_pos",
                  encoding((i[None, :] - i[:, None]).reshape(-1), pos_dim))  # [T*T, H*pd]
        rel = rel.view(T, T, H, pd).permute(2, 0, 1, 3)  # [H, i, j, pd]
        pos = (q(ph)[:, :, None, :] * q(rel)).sum(-1)
        att = torch.softmax(q(qh) @ q(kh).transpose(1, 2) + pos, dim=-1)  # [H, T, T]

        def ff(name, h):
            return lin(name + ".out_proj", swoosh_l(lin(name + ".in_proj", h)))

        def nla(h):
            s, u, v = lin(p + "nonlin_attention.in_proj", h).chunk(3, dim=-1)
            return lin(p + "nonlin_attention.out_proj", (q(att[0]) @ q(torch.tanh(s) * u)) * v)

        def sa(name, h):
            v = lin(name + ".in_proj", h).view(T, H, vd).transpose(0, 1)
            return lin(name + ".out_proj", (q(att) @ q(v)).transpose(0, 1).reshape(T, H * vd))

        def conv(name, h):
            a, g = lin(name + ".in_proj", h).chunk(2, dim=-1)
            h = (a * torch.sigmoid(g)).T[None]
            kw = w[name + ".depthwise.weight"]
            h = F.conv1d(q(h), q(kw), w[name + ".depthwise.bias"], padding=k // 2,
                         groups=kw.shape[0])[0].T
            return lin(name + ".out_proj", swoosh_r(h))

        x = x + ff(p + "feed_forward1", x)
        x = x + nla(x)
        x = x + sa(p + "self_attn1", x)
        x = x + conv(p + "conv_module1", x)
        x = x + ff(p + "feed_forward2", x)
        x = bypass(p + "bypass_mid", x0, x)
        x = x + sa(p + "self_attn2", x)
        x = x + conv(p + "conv_module2", x)
        x = x + ff(p + "feed_forward3", x)
        return bypass(p + "bypass", x0, bias_norm(p + "norm", x))

    saved = _no_tf32()
    try:
        T = x.shape[0]
        h = F.pad(x, (0, 0, 0, 7))[None, None]
        h = swoosh_r(conv2d("embed.conv0", h, padding=(0, 1)))
        h = swoosh_r(conv2d("embed.conv1", h, stride=2))
        h = swoosh_r(conv2d("embed.conv2", h, stride=(1, 2)))
        c = h.shape[1]
        h = h + conv2d("embed.convnext_pw2", swoosh_l(conv2d(
            "embed.convnext_pw1", conv2d("embed.convnext_dw", h, padding=3, groups=c))))
        h = h[0].permute(1, 0, 2).reshape(h.shape[2], -1)
        h = bias_norm("embed.out_norm", lin("embed.out", h))
        outs = []
        for s, (ds, n, d, H, k) in enumerate(zip(
                z["downsampling_factor"], z["num_encoder_layers"], z["encoder_dim"],
                z["num_heads"], z["cnn_module_kernel"])):
            h = h[:, :d] if d <= h.shape[1] else F.pad(h, (0, d - h.shape[1]))
            x0, T2 = h, h.shape[0]
            if ds > 1:
                h = down(f"stacks.{s}.downsample", h, ds)
            for j in range(n):
                h = layer(f"stacks.{s}.layers.{j}.", h, H, k)
            if ds > 1:
                h = bypass(f"stacks.{s}.out_combiner", x0, h.repeat_interleave(ds, 0)[:T2])
            outs.append(h)
        dims = z["encoder_dim"]
        parts, have = [outs[-1]], dims[-1]
        for out, d in zip(reversed(outs[:-1]), reversed(dims[:-1])):
            if d > have:
                parts.append(out[:, have:d])
                have = d
        h = down("downsample_output", torch.cat(parts, dim=1), z["output_downsampling_factor"])
        up = 2 * z["output_downsampling_factor"]
        need = -(-T // up)
        h = torch.cat([h, h[-1:].expand(need - h.shape[0], -1)]) if h.shape[0] < need else h
        h = F.conv_transpose1d(q(h.T[None]), q(w["head_upsample.weight"]),
                               w["head_upsample.bias"], stride=up)[0, :, :T].T
        return lin("output", h)
    finally:
        _restore(saved)


def scores(x: torch.Tensor, w: dict, log_priors_: torch.Tensor, cfg: dict,
           quant=None) -> torch.Tensor:
    """``x [T, in_dim]`` -> ``[T, classes]`` hybrid emission scores."""
    z = cfg["zipformer"]
    logp = torch.log_softmax(logits(x, w, cfg, quant).double(), dim=-1)
    return z["scale"] * (-(logp - z["prior_scale"] * log_priors_.double()))
