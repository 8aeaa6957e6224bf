"""Neural-network acoustic models and the hybrid DNN-HMM scorer, in PyTorch.

Counterpart of ``rasr_tpu/models/nn.py`` (flax): the feed-forward, conv,
BLSTM and conformer encoders, class priors and the hybrid scorer
(``score = scale * (-(log p(s|x) - prior_scale * log p(s)))``). Each
network is an ``nn.Module`` whose parameters live on ``device`` (the card
unless the caller names another, as the CPU tests do with ``"cpu"``);
``convert.nn_params_from_flax`` carries the JAX package's parameters
across, and :func:`init_params` draws new ones from a seed with flax's
initializers.

Every intermediate keeps the dtype flax gives it, so a ``"bfloat16"``
network rounds where the reference rounds:

- parameters stay float32 and are cast to the compute dtype at use; the
  matrix products, convolutions and activations between LayerNorms run
  in the compute dtype, logits return float32;
- LayerNorms compute in float32 with flax's eps of 1e-6;
- attention divides the query by ``sqrt(head_dim)`` in the compute
  dtype, takes ``Q K^T`` in it, fills masked scores with the dtype's
  most negative finite value (a fully masked row stays finite), runs the
  softmax in float32 and multiplies the float32 weights with the values
  in float32 (flax's ``force_fp32_for_softmax`` keeps the weights
  float32, and the product promotes);
- the conformer's input projection plus positions stays in the compute
  dtype, so block 0's residual stream does too; from block 1 on it is
  float32 (the final LayerNorm's output plus compute-dtype updates).

On CUDA every forward runs under :func:`strict_precision`: float32
products without TF32 and bf16 products reduced in float32, as the JAX
package computes on the CPU. Attention is the plain formulation above
(no fused attention kernel).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve
from .scorer import FeatureScorer, register_scorer

#: flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6

def _const(value: float, x: torch.Tensor) -> torch.Tensor:
    """A constant rounded to ``x``'s dtype, as JAX rounds a Python constant
    (PyTorch would compute with it in float32). A 0-dim host tensor: CUDA
    ops take it as a scalar argument, with no copy to the card."""
    return torch.tensor(value, dtype=torch.float32).to(x.dtype)


# The activations as the reference's elementwise ops, each rounded to its
# operands' dtype: jax.nn.sigmoid is 1 / (1 + exp(-x)), swish x * sigmoid(x),
# glu a * sigmoid(b), and gelu the tanh approximation (jax.nn.gelu's
# default). PyTorch's fused forms round once, which moves bf16 results.
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    one = _const(1.0, x)
    return one / (one + torch.exp(-x))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * sigmoid(b)


def gelu(x: torch.Tensor) -> torch.Tensor:
    inner = _const(math.sqrt(2.0 / math.pi), x) * (x + _const(0.044715, x) * (x * x * x))
    return x * (_const(0.5, x) * (_const(1.0, x) + torch.tanh(inner)))


_ACTS = {
    "sigmoid": sigmoid,
    "relu": F.relu,
    "tanh": torch.tanh,
    "gelu": gelu,
    "identity": lambda x: x,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


@contextlib.contextmanager
def strict_precision():
    """For its duration: float32 matrix products and cuDNN convolutions
    without TF32, and bf16 products reduced in float32 (PyTorch's CUDA
    defaults allow TF32 convolutions and bf16 split-K reductions). The
    previous settings come back on exit."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32)
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32 = saved


def _strict(forward):
    @functools.wraps(forward)
    def wrapped(*args, **kwargs):
        with strict_precision():
            return forward(*args, **kwargs)
    return wrapped


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input and parameters cast to ``dtype``,
    the product rounded to it before the bias is added."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def _dropout(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    return F.dropout(x, rate, training=True) if train and rate > 0.0 else x


class FeedForwardNet(nn.Module):
    """Hybrid FFNN over (spliced) frames: ``[..., D] -> [..., num_classes]``
    logits (flax names ``hidden{i}``, ``output``)."""

    def __init__(self, num_classes: int, in_dim: int, hidden: Sequence[int] = (512, 512),
                 activation: str = "relu", dropout: float = 0.0,
                 compute_dtype: str = "float32", device=None):
        super().__init__()
        device = resolve(device)
        widths = [in_dim, *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(widths[:-1], widths[1:]))
        self.output = nn.Linear(widths[-1], num_classes, device=device)
        self.act = _ACTS[activation]
        self.dropout = dropout
        self.cdt = _dtype(compute_dtype)

    @_strict
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self.hidden:
            x = _dropout(self.act(_dense(layer, x, self.cdt)), self.dropout, train)
        return _dense(self.output, x, self.cdt).float()


class ConvFrontendNet(nn.Module):
    """1-D convolutions over time (kernel 3, ``SAME`` padding), then a
    feed-forward stack: ``[B, T, D] -> [B, T, num_classes]`` (float32;
    flax names ``conv{i}``, ``hidden{i}``, ``output``)."""

    def __init__(self, num_classes: int, in_dim: int, channels: Sequence[int] = (64, 64),
                 hidden: Sequence[int] = (512,), activation: str = "relu", device=None):
        super().__init__()
        device = resolve(device)
        chans = [in_dim, *channels]
        self.conv = nn.ModuleList(
            nn.Conv1d(a, b, 3, padding="same", device=device) for a, b in zip(chans[:-1], chans[1:]))
        widths = [chans[-1], *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(widths[:-1], widths[1:]))
        self.output = nn.Linear(widths[-1], num_classes, device=device)
        self.act = _ACTS[activation]

    @_strict
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x.transpose(1, 2)  # channels first: [B, D, T]
        for conv in self.conv:
            h = self.act(conv(h))
        h = h.transpose(1, 2)
        for layer in self.hidden:
            h = self.act(layer(h))
        return self.output(h)


class BlstmEncoderNet(nn.Module):
    """Bidirectional-LSTM encoder over whole utterances ``[B, T, D] ->
    [B, T, num_classes]`` logits: per layer one bidirectional ``nn.LSTM``
    (gates i, f, g, o) whose outputs concatenate. With ``lengths`` each
    sequence is packed to its length, so the backward direction reads
    each utterance from its own last frame (flax's ``reverse=True,
    keep_order=True``); padded frames carry no meaning. Under
    ``"bfloat16"`` the whole LSTM runs in bf16, its cell state included
    (flax keeps the cell state float32)."""

    def __init__(self, num_classes: int, in_dim: int, hidden: Sequence[int] = (256, 256),
                 compute_dtype: str = "float32", device=None):
        super().__init__()
        device = resolve(device)
        widths = [in_dim] + [2 * w for w in hidden]
        self.layers = nn.ModuleList(
            nn.LSTM(a, w, batch_first=True, bidirectional=True, device=device)
            for a, w in zip(widths[:-1], hidden))
        # flax's cell has one bias per gate (its hidden projection's),
        # carried here as ``bias_hh``; ``bias_ih`` stays zero and out of
        # training, or every update would move the gates' bias twice
        for lstm in self.layers:
            for name, p in lstm.named_parameters():
                if name.startswith("bias_ih"):
                    p.detach().zero_()
                    p.requires_grad_(False)
        self.output = nn.Linear(widths[-1], num_classes, device=device)
        self.cdt = _dtype(compute_dtype)

    @_strict
    def forward(self, x: torch.Tensor, lengths=None, train: bool = False) -> torch.Tensor:
        B, T, _ = x.shape
        h = x.to(self.cdt)
        if lengths is not None:
            # pack_padded_sequence takes the lengths on the host, each at least 1
            lengths = torch.as_tensor(lengths).to("cpu", torch.int64).clamp(min=1)
        for lstm in self.layers:
            run = lstm
            if self.cdt != torch.float32:  # the parameters cast at use
                params = {k: v.to(self.cdt) for k, v in lstm.named_parameters()}

                def run(seq, lstm=lstm, params=params):
                    return torch.func.functional_call(lstm, params, (seq,))
            if lengths is None:
                h = run(h)[0]
            else:
                packed = nn.utils.rnn.pack_padded_sequence(h, lengths, batch_first=True,
                                                           enforce_sorted=False)
                h = nn.utils.rnn.pad_packed_sequence(run(packed)[0], batch_first=True,
                                                     total_length=T)[0]
        return _dense(self.output, h, self.cdt).float()


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no dropout):
    the ``query`` / ``key`` / ``value`` / ``out`` projections as
    ``[H * head_dim, d]`` linears."""

    def __init__(self, d_model: int, num_heads: int, device):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.query, self.key, self.value, self.out = (
            nn.Linear(d_model, d_model, device=device) for _ in range(4))

    def forward(self, h: torch.Tensor, mask: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
        B, T, d = h.shape
        H = self.num_heads
        hd = d // H

        def heads(layer):  # [B, T, d] -> [B, H, T, hd] in the compute dtype
            return _dense(layer, h, dtype).view(B, T, H, hd).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        # flax: query / jnp.sqrt(depth).astype(dtype), a float32 root rounded
        q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype)
        scores = q @ k.transpose(-1, -2)  # [B, H, T, T] in the compute dtype
        if mask is not None:
            # the most negative finite value: a fully masked (padded) query
            # row softmaxes to uniform weights, never to NaN
            scores = scores.masked_fill(~mask, torch.finfo(dtype).min)
        weights = torch.softmax(scores.float(), dim=-1)
        ctx = (weights @ v.float()).transpose(1, 2).reshape(B, T, d)  # float32
        return _dense(self.out, ctx, dtype)


class ConformerBlock(nn.Module):
    """One conformer block: half FF -> MHSA -> conv module -> half FF, all
    residual, final LayerNorm (flax names ``ff1_*``, ``mhsa_ln``,
    ``mhsa``, ``conv_ln``, ``conv_in``, ``conv_dw``, ``conv_bn``,
    ``conv_out``, ``ff2_*``, ``final_ln``)."""

    def __init__(self, d_model: int, num_heads: int = 4, ff_mult: int = 4,
                 conv_kernel: int = 15, dropout: float = 0.0,
                 compute_dtype: str = "float32", device=None):
        super().__init__()
        device = resolve(device)
        d = d_model

        def ln():
            return nn.LayerNorm(d, eps=LN_EPS, device=device)

        self.ff1_ln, self.ff2_ln = ln(), ln()
        self.ff1_in, self.ff2_in = (nn.Linear(d, d * ff_mult, device=device) for _ in range(2))
        self.ff1_out, self.ff2_out = (nn.Linear(d * ff_mult, d, device=device) for _ in range(2))
        self.mhsa_ln = ln()
        self.mhsa = MultiHeadAttention(d, num_heads, device)
        self.conv_ln = ln()
        self.conv_in = nn.Linear(d, 2 * d, device=device)
        # depthwise over time, flax's SAME padding
        self.conv_dw = nn.Conv1d(d, d, conv_kernel, padding="same", groups=d, device=device)
        self.conv_bn = ln()
        self.conv_out = nn.Linear(d, d, device=device)
        self.final_ln = ln()
        self.dropout = dropout
        self.cdt = _dtype(compute_dtype)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                attn_mask: Optional[torch.Tensor], train: bool = False) -> torch.Tensor:
        """``pad_mask`` ``[B, T, 1]`` (float32) and ``attn_mask`` ``[B, 1, T,
        T]`` (bool), or both None when every frame is valid."""
        cdt = self.cdt

        def drop(h):
            return _dropout(h, self.dropout, train)

        def norm(layer, h):  # LayerNorms compute in float32
            return layer(h.float())

        def ff(h, ln_, lin_in, lin_out):
            h = drop(swish(_dense(lin_in, norm(ln_, h), cdt)))
            return drop(_dense(lin_out, h, cdt))

        def masked(h):  # padded frames to 0
            return h if pad_mask is None else h * pad_mask.to(h.dtype)

        x = x + 0.5 * ff(x, self.ff1_ln, self.ff1_in, self.ff1_out)
        x = x + drop(self.mhsa(norm(self.mhsa_ln, x), attn_mask, cdt))
        h = glu(_dense(self.conv_in, norm(self.conv_ln, x), cdt))
        # zeroed padded frames: the depthwise window never reads them
        h = masked(h).transpose(1, 2)
        w = self.conv_dw
        h = F.conv1d(h, w.weight.to(cdt), padding="same", groups=w.groups).transpose(1, 2)
        h = _dense(self.conv_out, swish(norm(self.conv_bn, h + w.bias.to(cdt))), cdt)
        x = x + drop(masked(h))
        x = x + 0.5 * ff(x, self.ff2_ln, self.ff2_in, self.ff2_out)
        return norm(self.final_ln, x)


def sinusoidal_positions(T: int, d_model: int, device) -> torch.Tensor:
    """``[T, d_model]`` float32 sines then cosines (the reference's
    absolute encodings)."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2.0 * dim / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d_model]


class ConformerEncoderNet(nn.Module):
    """Conformer acoustic encoder ``[B, T, D] -> [B, T, num_classes]``
    logits (float32), frame-synchronous (no subsampling). With ``lengths``
    padded frames are masked out of attention and the conv modules, so
    ragged batched scoring equals scoring each valid prefix alone;
    without them every frame is valid and no mask is built."""

    def __init__(self, num_classes: int, in_dim: int, d_model: int = 256,
                 num_blocks: int = 4, num_heads: int = 4, ff_mult: int = 4,
                 conv_kernel: int = 15, dropout: float = 0.0,
                 compute_dtype: str = "float32", device=None):
        super().__init__()
        device = resolve(device)
        self.d_model = d_model
        self.input_proj = nn.Linear(in_dim, d_model, device=device)
        self.block = nn.ModuleList(
            ConformerBlock(d_model, num_heads, ff_mult, conv_kernel, dropout,
                           compute_dtype, device)
            for _ in range(num_blocks))
        self.output = nn.Linear(d_model, num_classes, device=device)
        self.cdt = _dtype(compute_dtype)

    @_strict
    def forward(self, x: torch.Tensor, lengths=None, train: bool = False) -> torch.Tensor:
        T = x.shape[1]
        pad_mask = attn_mask = None
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=x.device)
            valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
            pad_mask = valid[..., None].to(x.dtype)
            attn_mask = valid[:, None, None, :] & valid[:, None, :, None]
        h = _dense(self.input_proj, x, self.cdt)
        h = h + sinusoidal_positions(T, self.d_model, x.device).to(h.dtype)
        for block in self.block:
            h = block(h, pad_mask, attn_mask, train=train)
        if pad_mask is not None:
            h = h * pad_mask.to(h.dtype)
        return _dense(self.output, h, self.cdt).float()


def conformer_flop(cfg: dict, in_dim: int, classes: int, T: int):
    """(compute-dtype, float32) FLOP per frame of a forward pass of
    ``ConformerEncoderNet(**cfg)`` over utterances of T frames: the
    projections, feed-forwards, pointwise and depthwise convs and ``Q K^T``
    in the compute dtype, the attention weights times the values in
    float32 (flax's ``force_fp32_for_softmax``). A training step
    (forward, then a backward of twice the forward) is 3x this."""
    d, L, ff, k = cfg["d_model"], cfg["num_blocks"], cfg["ff_mult"], cfg["conv_kernel"]
    block = 2 * 2 * d * ff * d + 4 * d * d + d * 2 * d + d * d + d * k + T * d  # MACs
    return 2.0 * (in_dim * d + L * block + d * classes), 2.0 * L * T * d


def _truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """Normal draws truncated to [-2, 2] standard deviations (inverse CDF)."""
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * std).float()


def _lecun(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal of variance 1 / fan_in."""
    return _truncated_normal(shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978, gen)


def _orthogonal(n: int, gen: torch.Generator) -> torch.Tensor:
    q, r = torch.linalg.qr(torch.randn(n, n, generator=gen, dtype=torch.float64))
    return (q * torch.sign(torch.diagonal(r))).float()


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """New parameters for ``model`` from ``seed``, drawn on the host with
    flax's initializers: ``lecun_normal`` kernels (Dense, the attention
    projections, Conv over ``kernel x in / groups``), zero biases,
    LayerNorm scale 1 and bias 0, and for LSTMs ``lecun_normal`` input
    and orthogonal recurrent kernels per gate. The draws are the port's
    own, not JAX's."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.copy_(_lecun(mod.weight.shape, mod.in_features, gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Conv1d):
            w = mod.weight  # [out, in / groups, k]
            w.copy_(_lecun(w.shape, w.shape[1] * w.shape[2], gen))
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.LSTM):
            for name, p in mod.named_parameters():
                if name.startswith("weight_ih"):
                    p.copy_(_lecun(p.shape, p.shape[1], gen))
                elif name.startswith("weight_hh"):
                    p.copy_(torch.cat([_orthogonal(mod.hidden_size, gen) for _ in range(4)]))
                else:
                    p.zero_()
    return model


@dataclasses.dataclass
class StatePriors:
    """Class priors for hybrid scoring (natural-log priors ``[M]``)."""

    log_priors: np.ndarray

    @classmethod
    def from_counts(cls, counts: np.ndarray, smoothing: float = 1.0) -> "StatePriors":
        c = np.asarray(counts, np.float64) + smoothing
        return cls(np.log(c / c.sum()).astype(np.float32))

    def save(self, path: str) -> None:
        np.save(path if path.endswith(".npy") else path + ".npy", self.log_priors)

    @classmethod
    def load(cls, path: str) -> "StatePriors":
        return cls(np.load(path if path.endswith(".npy") else path + ".npy"))


class NnHybridScorer(FeatureScorer):
    """Network posteriors -> emission scores:
    ``score(s|x) = scale * (-log p(s|x) + prior_scale * log p(s))``.

    ``params`` is None (the model's own parameters) or a ``state_dict``
    for it (e.g. ``convert.nn_params_from_flax``); the model moves to
    ``device``. Length-aware networks (BLSTM, conformer) get the valid
    frame counts, so batched ragged scoring matches unbatched scoring."""

    def __init__(self, model: nn.Module, params, priors: StatePriors, scale: float = 1.0,
                 prior_scale: float = 1.0, device=None):
        super().__init__()
        device = resolve(device)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(device)
        self.register_buffer("log_priors", torch.as_tensor(
            np.asarray(priors.log_priors, np.float32), device=device))
        self.scale = scale
        self.prior_scale = prior_scale
        self.num_classes = int(priors.log_priors.shape[0])
        self._takes_lengths = "lengths" in inspect.signature(type(model).forward).parameters

    @torch.no_grad()
    def score(self, feats: torch.Tensor, lengths=None) -> torch.Tensor:
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.log_priors.device)
        if lengths is not None and self._takes_lengths:
            logits = self.model(feats, lengths=torch.as_tensor(lengths, device=feats.device))
        else:
            logits = self.model(feats)
        logp = torch.log_softmax(logits, dim=-1)
        return self.scale * (-(logp - self.prior_scale * self.log_priors))


register_scorer("nn-precomputed-hybrid")(NnHybridScorer)
register_scorer("nn-hybrid")(NnHybridScorer)
