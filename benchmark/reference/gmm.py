"""Diagonal-GMM emission scores in float64: the best density's -log(w N(x)).

Computed from (x - mean)^2 / var directly, not from the expanded products
the port's kernel computes.
"""

from __future__ import annotations

import math

import torch


def scores(feats: torch.Tensor, gmm: dict, var_floor: float, block: int = 256) -> torch.Tensor:
    """``feats [n, D]`` -> ``[n, M]`` -log p(x | class), float64 on
    ``feats``' device, ``block`` frames at a time."""
    dev = feats.device
    mean = torch.as_tensor(gmm["means"], device=dev, dtype=torch.float64)  # [M, K, D]
    var = torch.clamp(torch.as_tensor(gmm["variances"], device=dev, dtype=torch.float64),
                      min=var_floor)
    w = torch.as_tensor(gmm["weights"], device=dev, dtype=torch.float64)
    D = mean.shape[-1]
    const = -torch.log(w) + 0.5 * (D * math.log(2 * math.pi) + torch.log(var).sum(-1))  # [M, K]
    x = feats.to(torch.float64)
    out = []
    for i in range(0, x.shape[0], block):
        diff = x[i:i + block, None, None, :] - mean[None]  # [b, M, K, D]
        d = const[None] + 0.5 * (diff * diff / var[None]).sum(-1)
        out.append(d.min(-1).values)
    return torch.cat(out)


def scores_lowered(feats: torch.Tensor, gmm: dict, var_floor: float, quant) -> torch.Tensor:
    """The density scores as the two products ``x^2 a + x b`` (a = 0.5 /
    var, b = -mean / var) in float32 with their operands rounded by
    ``quant``: the lower-precision control."""
    dev = feats.device
    mean = torch.as_tensor(gmm["means"], device=dev, dtype=torch.float64)
    var = torch.clamp(torch.as_tensor(gmm["variances"], device=dev, dtype=torch.float64),
                      min=var_floor)
    w = torch.as_tensor(gmm["weights"], device=dev, dtype=torch.float64)
    M, K, D = mean.shape
    a = (0.5 / var).reshape(M * K, D).float()
    b = (-mean / var).reshape(M * K, D).float()
    c = (-torch.log(w) + 0.5 * (D * math.log(2 * math.pi) + torch.log(var).sum(-1)
                                + (mean * mean / var).sum(-1))).reshape(M * K).float()
    x = feats.float()
    d = quant(x * x) @ quant(a).T + quant(x) @ quant(b).T + c
    d = d.view(-1, M, K)
    return d.min(-1).values
