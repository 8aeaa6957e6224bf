"""The hybrid Zipformer: the port's ``ZipformerEncoderNet`` behind its
``NnHybridScorer``, with priors from drawn class counts and weights drawn
on the device in one call (:func:`draw_zipformer`)."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..reference import zipformer as reference

#: the embedding's channels after each 2-D convolution and its ConvNeXt's
#: hidden channels (icefall's ``Conv2dSubsampling``: 8, 32, 128; ratio 3)
EMBED_CHANNELS, CONVNEXT_HIDDEN = (8, 32, 128), 384


def draw(cfg: dict, rng, M: int, D: int) -> dict:
    """The class counts the priors are estimated from."""
    return {"prior_counts": rng.uniform(*cfg["zipformer"]["prior_counts"], size=M).astype(
        np.float32)}


def zipformer_param_specs(cfg: dict, in_dim: int, classes: int):
    """``(name, shape, init)`` of every Zipformer parameter, named as the
    port's ``ZipformerEncoderNet`` state dict names them. ``init`` is
    ``("lecun", fan_in)``, ``"zeros"`` or a number to fill with (the port's
    ``models/nn.py::init_params``)."""
    z = cfg["zipformer"]
    qd, vd, pd, pos_dim = z["query_head_dim"], z["value_head_dim"], z["pos_head_dim"], z["pos_dim"]
    specs = []

    def linear(name, n_in, n_out, bias=True):
        specs.append((f"{name}.weight", (n_out, n_in), ("lecun", n_in)))
        if bias:
            specs.append((f"{name}.bias", (n_out,), "zeros"))

    def conv(name, shape, fan_in):
        specs.append((f"{name}.weight", shape, ("lecun", fan_in)))
        specs.append((f"{name}.bias", (shape[0],), "zeros"))

    def bias_norm(name, d):
        specs.append((f"{name}.bias", (d,), "zeros"))
        specs.append((f"{name}.log_scale", (), "zeros"))

    (c1, c2, c3), hid = EMBED_CHANNELS, CONVNEXT_HIDDEN
    conv("embed.conv0", (c1, 1, 3, 3), 9)
    conv("embed.conv1", (c2, c1, 3, 3), 9 * c1)
    conv("embed.conv2", (c3, c2, 3, 3), 9 * c2)
    conv("embed.convnext_dw", (c3, 1, 7, 7), 49)
    conv("embed.convnext_pw1", (hid, c3, 1, 1), c3)
    conv("embed.convnext_pw2", (c3, hid, 1, 1), hid)
    freq = ((in_dim - 3) // 2 + 1 - 3) // 2 + 1
    dims = z["encoder_dim"]
    linear("embed.out", c3 * freq, dims[0])
    bias_norm("embed.out_norm", dims[0])
    for s, (ds, n, d, ff, H, k) in enumerate(zip(
            z["downsampling_factor"], z["num_encoder_layers"], dims, z["feedforward_dim"],
            z["num_heads"], z["cnn_module_kernel"])):
        for j in range(n):
            p = f"stacks.{s}.layers.{j}."
            linear(p + "self_attn_weights.in_proj", d, H * (2 * qd + pd))
            linear(p + "self_attn_weights.linear_pos", pos_dim, H * pd, bias=False)
            for i, h in ((1, 3 * ff // 4), (2, ff), (3, 5 * ff // 4)):
                linear(p + f"feed_forward{i}.in_proj", d, h)
                linear(p + f"feed_forward{i}.out_proj", h, d)
            linear(p + "nonlin_attention.in_proj", d, 3 * (3 * d // 4))
            linear(p + "nonlin_attention.out_proj", 3 * d // 4, d)
            for i in (1, 2):
                linear(p + f"self_attn{i}.in_proj", d, H * vd)
                linear(p + f"self_attn{i}.out_proj", H * vd, d)
            for i in (1, 2):
                linear(p + f"conv_module{i}.in_proj", d, 2 * d)
                conv(p + f"conv_module{i}.depthwise", (d, 1, k), k)
                linear(p + f"conv_module{i}.out_proj", d, d)
            bias_norm(p + "norm", d)
            specs.append((p + "bypass_mid.scale", (d,), 0.5))
            specs.append((p + "bypass.scale", (d,), 0.5))
        if ds > 1:
            specs.append((f"stacks.{s}.downsample.weights", (ds,), "zeros"))
            specs.append((f"stacks.{s}.out_combiner.scale", (d,), 0.5))
    specs.append(("downsample_output.weights", (z["output_downsampling_factor"],), "zeros"))
    W, up = max(dims), 2 * z["output_downsampling_factor"]
    conv("head_upsample", (W, W, up), W * up)
    linear("output", W, classes)
    return specs


def draw_zipformer(cfg: dict, in_dim: int, classes: int, seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """The Zipformer's float32 weights, drawn on ``device`` from ``seed`` in
    one call: lecun-normal kernels (normal truncated to two deviations, by
    the inverse CDF of one uniform draw), zero biases, BiasNorms and
    downsampling weights, bypass scales 0.5."""
    specs = zipformer_param_specs(cfg, in_dim, classes)
    sizes = [math.prod(s) for _, s, init in specs if isinstance(init, tuple)]
    gen = torch.Generator(device=device).manual_seed(seed)
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(sum(sizes), generator=gen, device=device) * (hi - lo) + lo
    z = torch.erfinv(2.0 * u - 1.0).mul_(math.sqrt(2.0))
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif isinstance(init, float):
            out[name] = torch.full(shape, init, device=device)
        else:
            n = math.prod(shape)
            std = math.sqrt(1.0 / init[1]) / 0.87962566103423978
            out[name] = (z[at:at + n] * std).view(shape)
            at += n
    return out


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return draw_zipformer(cfg, cfg["frontend"]["feat_dim"], cfg["tying"]["num_classes"], seed,
                          device)


def tiny(cfg: dict) -> None:
    """All six stacks and five rates, one layer each, widths 16-32."""
    cfg["zipformer"].update(
        num_encoder_layers=[1] * 6, encoder_dim=[16, 24, 32, 32, 24, 16],
        feedforward_dim=[32, 48, 64, 64, 48, 32], num_heads=[2] * 6,
        cnn_module_kernel=[5, 5, 3, 3, 3, 5], query_head_dim=8, value_head_dim=4,
        pos_head_dim=2, pos_dim=8)


def net(cfg: dict, weights: Dict[str, torch.Tensor], device):
    from rasr_tpu_torch.models.zipformer import ZipformerEncoderNet

    z = cfg["zipformer"]
    keys = ("num_encoder_layers", "downsampling_factor", "encoder_dim", "feedforward_dim",
            "num_heads", "cnn_module_kernel", "query_head_dim", "value_head_dim", "pos_head_dim",
            "pos_dim", "output_downsampling_factor", "compute_dtype")
    out = ZipformerEncoderNet(cfg["tying"]["num_classes"], cfg["frontend"]["feat_dim"],
                              device=device, **{k: z[k] for k in keys})
    with torch.no_grad():
        out.load_state_dict(weights, strict=True)
    return out


def scorer(cfg: dict, draws, weights, device):
    from rasr_tpu_torch.models.nn import NnHybridScorer, StatePriors

    z = cfg["zipformer"]
    return NnHybridScorer(net(cfg, weights, device), None,
                          StatePriors.from_counts(draws.acoustic["prior_counts"]),
                          scale=z["scale"], prior_scale=z["prior_scale"], device=device)


# counts/zipformer.py imports this module's specs, so its counts are imported at call time
def forward_work(frames, cfg: dict):
    from ..counts import zipformer as counts

    return counts.forward_work(frames, cfg)


def train_step_work(batch: int, frames: int, cfg: dict):
    from ..counts import zipformer as counts

    return counts.train_step_work(batch, frames, cfg)


def reference_scores(feats, draws, weights, cfg: dict, quant=None):
    priors = reference.log_priors(draws.acoustic["prior_counts"], feats.device)
    return reference.scores(feats.float(), weights, priors, cfg, quant)


reference_logits = reference.logits
