"""An acoustic model that only the tests know: the port's ``BlstmEncoderNet``
at toy widths behind its ``NnHybridScorer``, with its plain reference and
its work counts written here. ``test_harness_open.py`` puts it where
``spec.model`` finds ``benchmark/models/toy_blstm.py``: a new model needs
new files and no edit to the harness.

The reference runs each direction of each layer frame by frame in
float32: gates ``x W_ih^T + h W_hh^T + b_hh`` (flax's one bias a gate; the
port's ``bias_ih`` stays zero and untrained), in PyTorch's order i, f, g,
o, the cell state ``c = f c + i g`` and the output ``h = o tanh(c)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.counts import Work


def _specs(cfg: dict):
    """``(name, shape)`` of every parameter, named as the port's state dict."""
    widths = [cfg["frontend"]["feat_dim"]] + [2 * w for w in cfg["toy_blstm"]["hidden"]]
    out = []
    for i, (a, w) in enumerate(zip(widths[:-1], cfg["toy_blstm"]["hidden"])):
        for sfx in ("", "_reverse"):
            p = f"layers.{i}."
            out += [(p + "weight_ih_l0" + sfx, (4 * w, a)), (p + "weight_hh_l0" + sfx, (4 * w, w)),
                    (p + "bias_ih_l0" + sfx, (4 * w,)), (p + "bias_hh_l0" + sfx, (4 * w,))]
    return out + [("output.weight", (cfg["tying"]["num_classes"], widths[-1])),
                  ("output.bias", (cfg["tying"]["num_classes"],))]


def draw(cfg: dict, rng, M: int, D: int) -> dict:
    return {"prior_counts": rng.uniform(*cfg["toy_blstm"]["prior_counts"], size=M).astype(
        np.float32)}


def weights(cfg: dict, seed: int, device) -> dict:
    """Matrices uniform in +-1/sqrt(fan in), drawn on ``device`` from
    ``seed``; biases zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in _specs(cfg):
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
        else:
            u = torch.rand(shape, generator=gen, device=device)
            out[name] = (2.0 * u - 1.0) / math.sqrt(shape[1])
    return out


def tiny(cfg: dict) -> None:
    """Already toy widths."""


def net(cfg: dict, weights: dict, device):
    from rasr_tpu_torch.models.nn import BlstmEncoderNet

    out = BlstmEncoderNet(cfg["tying"]["num_classes"], cfg["frontend"]["feat_dim"],
                          hidden=tuple(cfg["toy_blstm"]["hidden"]), device=device)
    with torch.no_grad():
        out.load_state_dict(weights, strict=True)
    return out


def scorer(cfg: dict, draws, weights: dict, device):
    from rasr_tpu_torch.models.nn import NnHybridScorer, StatePriors

    c = cfg["toy_blstm"]
    return NnHybridScorer(net(cfg, weights, device), None,
                          StatePriors.from_counts(draws.acoustic["prior_counts"]),
                          scale=c["scale"], prior_scale=c["prior_scale"], device=device)


def _flop_per_frame(cfg: dict) -> float:
    return sum(2.0 * math.prod(s) for n, s in _specs(cfg) if n.split(".")[-1].startswith("weight"))


def forward_work(frames, cfg: dict) -> Work:
    N = float(sum(frames))
    params = sum(math.prod(s) for _, s in _specs(cfg))
    D, M = cfg["frontend"]["feat_dim"], cfg["tying"]["num_classes"]
    return Work({"fp32": N * _flop_per_frame(cfg)}, 4.0 * (params + N * (D + M)))


def train_step_work(batch: int, frames: int, cfg: dict) -> Work:
    return Work({"fp32": 3.0 * batch * frames * _flop_per_frame(cfg)})


def reference_logits(x: torch.Tensor, w: dict, cfg: dict, quant=None) -> torch.Tensor:
    """``x [T, D]`` float32 -> ``[T, classes]`` logits."""
    q = quant or (lambda t: t)
    T = x.shape[0]
    h = x
    for i, H in enumerate(cfg["toy_blstm"]["hidden"]):
        outs = []
        for sfx, order in (("", range(T)), ("_reverse", range(T - 1, -1, -1))):
            p = f"layers.{i}."
            xi = q(h) @ q(w[p + "weight_ih_l0" + sfx]).T + w[p + "bias_hh_l0" + sfx]
            wh = q(w[p + "weight_hh_l0" + sfx])
            ht, ct, hs = x.new_zeros(H), x.new_zeros(H), [None] * T
            for t in order:
                gi, gf, gg, go = (xi[t] + q(ht) @ wh.T).chunk(4)
                ct = torch.sigmoid(gf) * ct + torch.sigmoid(gi) * torch.tanh(gg)
                ht = torch.sigmoid(go) * torch.tanh(ct)
                hs[t] = ht
            outs.append(torch.stack(hs))
        h = torch.cat(outs, dim=-1)
    return q(h) @ q(w["output.weight"]).T + w["output.bias"]


def reference_scores(feats, draws, weights: dict, cfg: dict, quant=None) -> torch.Tensor:
    c = cfg["toy_blstm"]
    counts = torch.as_tensor(draws.acoustic["prior_counts"], dtype=torch.float64) + 1.0
    log_priors = torch.log(counts / counts.sum()).to(feats.device)
    logp = torch.log_softmax(reference_logits(feats.float(), weights, cfg, quant).double(), -1)
    return c["scale"] * (-(logp - c["prior_scale"] * log_priors))
