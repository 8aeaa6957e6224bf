"""The hybrid conformer: the port's ``ConformerEncoderNet`` behind its
``NnHybridScorer``, with priors from drawn class counts and weights drawn
on the device (:func:`draw_conformer`)."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..reference import conformer as reference


def draw(cfg: dict, rng, M: int, D: int) -> dict:
    """The class counts the priors are estimated from."""
    return {"prior_counts": rng.uniform(*cfg["conformer"]["prior_counts"], size=M).astype(
        np.float32)}


def conformer_param_specs(cfg: dict, in_dim: int, classes: int):
    """``(name, shape, init)`` of every conformer parameter, named as the
    port's ``ConformerEncoderNet`` state dict names them. ``init`` is
    ``("lecun", fan_in)``, ``"zeros"`` or ``"ones"`` (flax's initializers)."""
    c = cfg["conformer"]
    d, ff, k = c["d_model"], c["d_model"] * c["ff_mult"], c["conv_kernel"]
    specs = []

    def linear(name, n_in, n_out):
        specs.append((f"{name}.weight", (n_out, n_in), ("lecun", n_in)))
        specs.append((f"{name}.bias", (n_out,), "zeros"))

    def ln(name):
        specs.append((f"{name}.weight", (d,), "ones"))
        specs.append((f"{name}.bias", (d,), "zeros"))

    linear("input_proj", in_dim, d)
    for i in range(c["num_blocks"]):
        p = f"block.{i}."
        ln(p + "ff1_ln"), ln(p + "ff2_ln")
        linear(p + "ff1_in", d, ff), linear(p + "ff2_in", d, ff)
        linear(p + "ff1_out", ff, d), linear(p + "ff2_out", ff, d)
        ln(p + "mhsa_ln")
        for proj in ("query", "key", "value", "out"):
            linear(p + "mhsa." + proj, d, d)
        ln(p + "conv_ln")
        linear(p + "conv_in", d, 2 * d)
        specs.append((p + "conv_dw.weight", (d, 1, k), ("lecun", k)))
        specs.append((p + "conv_dw.bias", (d,), "zeros"))
        ln(p + "conv_bn")
        linear(p + "conv_out", d, d)
        ln(p + "final_ln")
    linear("output", d, classes)
    return specs


def draw_conformer(cfg: dict, in_dim: int, classes: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The conformer's float32 weights, drawn on ``device`` from ``seed`` in
    one call: lecun-normal kernels (normal truncated to two deviations,
    by the inverse CDF of one uniform draw), zero biases, unit LayerNorm
    scales."""
    specs = conformer_param_specs(cfg, in_dim, classes)
    sizes = [math.prod(s) for _, s, init in specs if isinstance(init, tuple)]
    gen = torch.Generator(device=device).manual_seed(seed)
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(sum(sizes), generator=gen, device=device) * (hi - lo) + lo
    z = torch.erfinv(2.0 * u - 1.0).mul_(math.sqrt(2.0))
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            std = math.sqrt(1.0 / init[1]) / 0.87962566103423978
            out[name] = (z[at:at + n] * std).view(shape)
            at += n
    return out


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return draw_conformer(cfg, cfg["frontend"]["feat_dim"], cfg["tying"]["num_classes"], seed,
                          device)


def tiny(cfg: dict) -> None:
    cfg["conformer"].update(d_model=32, num_blocks=2, num_heads=2)


def net(cfg: dict, weights: Dict[str, torch.Tensor], device):
    from rasr_tpu_torch.models.nn import ConformerEncoderNet

    c = cfg["conformer"]
    out = ConformerEncoderNet(cfg["tying"]["num_classes"], cfg["frontend"]["feat_dim"],
                              d_model=c["d_model"], num_blocks=c["num_blocks"],
                              num_heads=c["num_heads"], ff_mult=c["ff_mult"],
                              conv_kernel=c["conv_kernel"], compute_dtype=c["compute_dtype"],
                              device=device)
    with torch.no_grad():
        out.load_state_dict(weights, strict=True)
    return out


def scorer(cfg: dict, draws, weights, device):
    from rasr_tpu_torch.models.nn import NnHybridScorer, StatePriors

    c = cfg["conformer"]
    return NnHybridScorer(net(cfg, weights, device), None,
                          StatePriors.from_counts(draws.acoustic["prior_counts"]),
                          scale=c["scale"], prior_scale=c["prior_scale"], device=device)


# counts/conformer.py imports this module's specs, so its counts are imported at call time
def forward_work(frames, cfg: dict):
    from ..counts import conformer as counts

    return counts.forward_work(frames, cfg)


def train_step_work(batch: int, frames: int, cfg: dict):
    from ..counts import conformer as counts

    return counts.train_step_work(batch, frames, cfg)


def reference_scores(feats, draws, weights, cfg: dict, quant=None):
    priors = reference.log_priors(draws.acoustic["prior_counts"], feats.device)
    return reference.scores(feats.float(), weights, priors, cfg, quant)


reference_logits = reference.logits
