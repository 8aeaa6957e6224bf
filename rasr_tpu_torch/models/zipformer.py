"""Zipformer (Yao et al., "Zipformer: A faster and better encoder for
automatic speech recognition", ICLR 2024) as a hybrid acoustic model.

:class:`ZipformerEncoderNet` maps features ``x [B, T, D]`` at 100 Hz to
class logits ``[B, T, C]`` (float32): a 2-D convolutional embedding down
to 50 Hz, six stacks of Zipformer layers at five frame rates, their
outputs combined and halved to 25 Hz, and a hybrid head back to 100 Hz.
The precision rules are those of ``models/nn.py``: products in the
compute dtype through ``_dense`` (or the convolution's own call on
operands cast to it), the residual stream float32, the attention
softmax, BiasNorm and the downsampling weights' softmax in float32, the
attention weights times the values in float32, the whole forward under
``strict_precision()``. Masked keys take float32's most negative finite
value.

A layer maps ``x [B, T_k, d]`` at one rate; ``x0`` is its input.

- Attention weights, once a layer, from ``x0``: one linear layer ``d ->
  H (2 * 32 + 4)`` gives Q and K (H x 32 each) and p (H x 4); ``W_pos``
  (48 -> 4H, no bias) maps the compact relative encoding ``e(j - i)``.
  ``A_h = softmax_j(Q_h,i . K_h,j + p_h,i . W_pos e(j - i))``, no
  ``1/sqrt(d)`` scale; A is ``[H, B, T, T]``.
- In order: ``x += FF1(x)``; ``x += NLA(x, A_0)``; ``x += SA1(x, A)``;
  ``x += Conv1(x)``; ``x += FF2(x)``; ``x = x0 + c_mid (x - x0)``;
  ``x += SA2(x, A)``; ``x += Conv2(x)``; ``x += FF3(x)``; ``x =
  BiasNorm(x)``; ``x = x0 + c (x - x0)``.
- ``FFn(x) = W2 SwooshL(W1 x)``, hidden ``floor(3F/4)``, ``F``,
  ``floor(5F/4)`` for n = 1, 2, 3.
- ``NLA``: ``[s, u, v] = W_in x`` (3d/4 each), ``W_out((A_0 (tanh(s) u))
  v)``.
- ``SA``: per head ``v_h = W_v x`` (12 dims), ``W_o concat_h(A_h v_h)``.
- ``Conv``: ``[a, g] = W_in x`` (d each), ``a sigmoid(g)``, padded frames
  zeroed, a depthwise convolution (kernel k, same padding), SwooshR,
  ``W_out``.
- ``BiasNorm(x) = x exp(gamma) mean_c((x - b)^2)^(-1/2)``.
- ``SwooshR(z) = log(1 + e^(z-1)) - 0.08 z - 0.313261687``,
  ``SwooshL(z) = log(1 + e^(z-4)) - 0.08 z - 0.035``.
- ``e(delta)``, with ``L = sqrt(48)``: ``delta' = L sign(delta) (log(|delta|
  + L) - log L)``, ``theta = atan(delta' 2 pi / 48)``, ``e[2m] = cos((m+1)
  theta)``, ``e[2m+1] = sin((m+1) theta)``, ``e[47] = 1``.

Stack k runs ``layers_k`` layers of width ``d_k`` at ``1/ds_k`` of the
50-Hz rate; its input is the previous stack's output with its channels
zero-padded or cut to ``d_k``. With ``ds > 1``: ``x0 = x``; Down (time
padded with the last valid frame to a multiple of ds, each group of ds
frames summed with weights ``softmax(w)``); the layers; Up (each frame
repeated ds times, cropped); ``x = x0 + c_out (x - x0)``. At rate ds a
frame is valid while its index is under ``ceil(L'/ds)``, L' the 50-Hz
length. The output takes the last stack's channels, then each earlier
stack's channels above those (``768 = 256 + 256 + 256`` from stacks 5, 4
and 3), and Down by 2 gives 25 Hz.

The embedding pads ``x`` (zero past each utterance's end) with 7 zero
frames, so that ``T' = T // 2``: Conv2d(1 -> 8, 3x3, padding (0, 1)),
SwooshR; Conv2d(8 -> 32, 3x3, stride 2), SwooshR; Conv2d(32 -> 128,
3x3, stride (1, 2)), SwooshR; ConvNeXt (7x7 depthwise, 1x1 to 384,
SwooshL, 1x1 back, residual) on frames zeroed past ``L'``; flattened
channels x frequencies, Linear, BiasNorm.

The hybrid head: a transposed convolution (kernel and stride 4) back to
100 Hz, cropped to T, then a Linear to the classes. A 25-Hz sequence
short of ``ceil(T / 4)`` frames (an odd T leaves one) is extended with
its last valid frame first. Padded frames are zeroed before the Linear,
as the conformer zeroes them.

With ``lengths`` a ragged batch equals each utterance scored alone:
every rate masks its keys and its convolutions' inputs, and Down reads
the last valid frame where the utterance ends. icefall's training-only
modules (Balancer, Whiten, ScaleGrad, skip and dropout rates) are
identities here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve
from ..utils import profiling
from .nn import _dense, _dtype, _strict

#: the stacks of Zipformer-L (icefall's large recipe)
LARGE = dict(num_encoder_layers=(2, 2, 4, 5, 4, 2), downsampling_factor=(1, 2, 4, 8, 4, 2),
             encoder_dim=(192, 256, 512, 768, 512, 256),
             feedforward_dim=(512, 768, 1536, 2048, 1536, 768), num_heads=(4, 4, 4, 8, 4, 4),
             cnn_module_kernel=(31, 31, 15, 15, 15, 31))
#: the embedding's channels after each 2-D convolution, and its ConvNeXt's hidden channels
EMBED_CHANNELS, CONVNEXT_HIDDEN = (8, 32, 128), 384


def _swoosh_r32(zf: torch.Tensor) -> torch.Tensor:
    return F.softplus(zf - 1.0).add_(zf, alpha=-0.08).sub_(0.313261687)


def swoosh_r(z: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^(z-1)) - 0.08 z - 0.313261687``, computed in float32,
    returned in ``z``'s dtype."""
    return _swoosh_r32(z.float()).to(z.dtype)


def swoosh_l(z: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^(z-4)) - 0.08 z - 0.035``, computed in float32,
    returned in ``z``'s dtype."""
    zf = z.float()
    return F.softplus(zf - 4.0).add_(zf, alpha=-0.08).sub_(0.035).to(z.dtype)


def compact_positions(T: int, dim: int, device) -> torch.Tensor:
    """``[2T - 1, dim]`` float32: row ``k`` is ``e(k - (T - 1))``, the
    compact relative encoding of the offsets ``-(T-1) .. T-1``."""
    delta = torch.arange(-(T - 1), T, dtype=torch.float64, device=device)
    L = math.sqrt(dim)
    comp = L * torch.sign(delta) * (torch.log(delta.abs() + L) - math.log(L))
    theta = torch.atan(comp * (2.0 * math.pi / dim))[:, None]
    ang = theta * torch.arange(1, dim // 2 + 1, dtype=torch.float64, device=device)
    e = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1).reshape(2 * T - 1, dim)
    e[:, -1] = 1.0
    return e.float()


def _clamped(T: int, valid: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    """Frame indices ``0 .. n-1`` with each row's index held at its last
    valid frame: ``[B, n]`` (``valid`` given) or ``[1, n]`` (``T`` frames
    valid)."""
    t = torch.arange(n, device=device)[None, :]
    last = (valid[:, None] if valid is not None else torch.tensor([[T]], device=device)) - 1
    return torch.minimum(t, last.clamp(min=0))


def _gather_frames(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [B, T, d]`` at frames ``idx [B or 1, n]``."""
    return torch.gather(x, 1, idx.expand(x.shape[0], -1)[..., None].expand(-1, -1, x.shape[2]))


def _frames(valid: Optional[torch.Tensor], n: int, device, dtype):
    """The masked keys ``[1, B, 1, n]`` (bool: True past each row's
    ``valid`` frames) and the frame mask ``[B, n, 1]`` (in ``dtype``: 1 on
    the valid frames), or (None, None)."""
    if valid is None:
        return None, None
    ok = torch.arange(n, device=device)[None, :] < valid[:, None]
    return ~ok[None, :, None, :], ok[..., None].to(dtype)


def _masked(h: torch.Tensor, pad: Optional[torch.Tensor]) -> torch.Tensor:
    return h if pad is None else h * pad.to(h.dtype)


class _Cast:
    """A layer's weight and bias in the compute dtype."""

    __slots__ = ("weight", "bias")

    def __init__(self, weight, bias):
        self.weight, self.bias = weight, bias


class Compute:
    """The compute dtype, and the product layers' weights and biases in it
    (``c(layer)``). Below float32 every one of them is cast in one
    operation a forward, on their concatenation, and their gradients come
    back in one cast: the values of a cast a parameter, at a few launches
    in place of two a parameter."""

    def __init__(self, layers: Sequence[nn.Module], dtype: torch.dtype):
        self.dtype = dtype
        self._cast = None
        if dtype == torch.float32:
            return
        tensors = [t for m in layers for t in (m.weight, m.bias) if t is not None]
        parts = iter(torch.cat([t.reshape(-1) for t in tensors]).to(dtype).split(
            [t.numel() for t in tensors]))
        self._cast = {}
        for m in layers:
            w = next(parts).view(m.weight.shape)
            self._cast[m] = _Cast(w, None if m.bias is None else next(parts).view(m.bias.shape))

    def __call__(self, layer: nn.Module):
        return layer if self._cast is None else self._cast[layer]


class BiasNorm(nn.Module):
    """``x exp(log_scale) mean_c((x - bias)^2)^(-1/2)`` in float32."""

    def __init__(self, d: int, device):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(d, device=device))
        self.log_scale = nn.Parameter(torch.zeros((), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * (torch.mean((x - self.bias) ** 2, dim=-1, keepdim=True).rsqrt()
                    * self.log_scale.exp())


class Bypass(nn.Module):
    """``x0 + scale (x - x0)``, a learned scale per channel."""

    def __init__(self, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.full((d,), 0.5, device=device))

    def forward(self, x0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x0 + self.scale * (x - x0)


class Downsample(nn.Module):
    """Each group of ``ds`` frames summed with weights ``softmax(weights)``
    (float32), time padded with each row's last valid frame."""

    def __init__(self, ds: int, device):
        super().__init__()
        self.ds = ds
        self.weights = nn.Parameter(torch.zeros(ds, device=device))

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, d = x.shape
        n = -(-T // self.ds)
        x = _gather_frames(x.float(), _clamped(T, valid, n * self.ds, x.device))
        w = torch.softmax(self.weights.float(), dim=0)
        return (x.view(B, n, self.ds, d) * w[:, None]).sum(dim=2)


class FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int, device):
        super().__init__()
        self.in_proj = nn.Linear(d, hidden, device=device)
        self.out_proj = nn.Linear(hidden, d, device=device)

    def forward(self, x, c):
        return _dense(c(self.out_proj), swoosh_l(_dense(c(self.in_proj), x, c.dtype)), c.dtype)


class AttentionWeights(nn.Module):
    """The layer's relative-position attention weights ``[H, B, T, T]``
    (float32)."""

    def __init__(self, d: int, H: int, qd: int, pd: int, pos_dim: int, device):
        super().__init__()
        self.H, self.qd, self.pd = H, qd, pd
        self.in_proj = nn.Linear(d, H * (2 * qd + pd), device=device)
        self.linear_pos = nn.Linear(pos_dim, H * pd, bias=False, device=device)

    def forward(self, x, pos, masked_keys, c):
        B, T, _ = x.shape
        H, qd, pd = self.H, self.qd, self.pd
        q, k, p = _dense(c(self.in_proj), x, c.dtype).split([H * qd, H * qd, H * pd], dim=-1)
        q = q.reshape(B, T, H, qd).permute(2, 0, 1, 3)  # [H, B, T, qd]
        k = k.reshape(B, T, H, qd).permute(2, 0, 3, 1)  # [H, B, qd, T]
        p = p.reshape(B * T, H, pd).transpose(0, 1)  # [H, B*T, pd], a view
        rel = _dense(c(self.linear_pos), pos, c.dtype).view(2 * T - 1, H, pd).permute(1, 2, 0)
        # [H, B, T, 2T-1]: column k is the offset k - (T-1)
        ps = torch.bmm(p, rel).view(H, B, T, 2 * T - 1)
        # row i, column j reads offset j - i: column T - 1 + j - i of row i
        ps = ps.as_strided((H, B, T, T), (B * T * (2 * T - 1), T * (2 * T - 1), 2 * T - 2, 1),
                           ps.storage_offset() + T - 1)
        scores = torch.matmul(q, k).float() + ps.float()
        if masked_keys is not None:
            scores = scores.masked_fill(masked_keys, torch.finfo(torch.float32).min)
        return torch.softmax(scores, dim=-1)


class NonlinAttention(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        h = 3 * d // 4
        self.in_proj = nn.Linear(d, 3 * h, device=device)
        self.out_proj = nn.Linear(h, d, device=device)

    def forward(self, x, a0, c):
        s, u, v = _dense(c(self.in_proj), x, c.dtype).chunk(3, dim=-1)
        z = torch.matmul(a0, (torch.tanh(s) * u).float())  # [B, T, h] float32
        return _dense(c(self.out_proj), z * v, c.dtype)


class SelfAttention(nn.Module):
    def __init__(self, d: int, H: int, vd: int, device):
        super().__init__()
        self.H, self.vd = H, vd
        self.in_proj = nn.Linear(d, H * vd, device=device)
        self.out_proj = nn.Linear(H * vd, d, device=device)

    def forward(self, x, a, c):
        B, T, _ = x.shape
        v = _dense(c(self.in_proj), x, c.dtype).reshape(B, T, self.H, self.vd).permute(2, 0, 1, 3)
        o = torch.matmul(a, v.to(torch.float32, memory_format=torch.contiguous_format))
        # [B, T, H, vd] in the compute dtype, in one copy
        o = o.permute(1, 2, 0, 3).to(c.dtype, memory_format=torch.contiguous_format)
        return _dense(c(self.out_proj), o.reshape(B, T, self.H * self.vd), c.dtype)


class ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int, device):
        super().__init__()
        self.in_proj = nn.Linear(d, 2 * d, device=device)
        self.depthwise = nn.Conv1d(d, d, kernel, padding=kernel // 2, groups=d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)

    def forward(self, x, pad, c):
        a, g = _dense(c(self.in_proj), x, c.dtype).chunk(2, dim=-1)
        h = _masked(a * torch.sigmoid(g), pad).transpose(1, 2)
        dw, w = self.depthwise, c(self.depthwise)
        h = F.conv1d(h, w.weight, w.bias, padding=dw.padding, groups=dw.groups)  # [B, d, T]
        h = _swoosh_r32(h.float()).transpose(1, 2).to(c.dtype, memory_format=torch.contiguous_format)
        return _dense(c(self.out_proj), h, c.dtype)


class ZipformerLayer(nn.Module):
    def __init__(self, d: int, ff: int, H: int, kernel: int, qd: int, vd: int, pd: int,
                 pos_dim: int, device):
        super().__init__()
        self.self_attn_weights = AttentionWeights(d, H, qd, pd, pos_dim, device)
        self.feed_forward1 = FeedForward(d, 3 * ff // 4, device)
        self.feed_forward2 = FeedForward(d, ff, device)
        self.feed_forward3 = FeedForward(d, 5 * ff // 4, device)
        self.nonlin_attention = NonlinAttention(d, device)
        self.self_attn1 = SelfAttention(d, H, vd, device)
        self.self_attn2 = SelfAttention(d, H, vd, device)
        self.conv_module1 = ConvModule(d, kernel, device)
        self.conv_module2 = ConvModule(d, kernel, device)
        self.norm = BiasNorm(d, device)
        self.bypass_mid = Bypass(d, device)
        self.bypass = Bypass(d, device)

    def forward(self, x, pos, masked_keys, pad, c):
        x0 = x
        a = self.self_attn_weights(x, pos, masked_keys, c)
        x = x + self.feed_forward1(x, c)
        x = x + self.nonlin_attention(x, a[0], c)
        x = x + self.self_attn1(x, a, c)
        x = x + self.conv_module1(x, pad, c)
        x = x + self.feed_forward2(x, c)
        x = self.bypass_mid(x0, x)
        x = x + self.self_attn2(x, a, c)
        x = x + self.conv_module2(x, pad, c)
        x = x + self.feed_forward3(x, c)
        return self.bypass(x0, self.norm(x))


class ZipformerStack(nn.Module):
    """``layers`` Zipformer layers at ``1/ds`` of the input rate."""

    def __init__(self, ds: int, layers: int, d: int, ff: int, H: int, kernel: int, qd: int,
                 vd: int, pd: int, pos_dim: int, device):
        super().__init__()
        self.ds, self.d, self.pos_dim = ds, d, pos_dim
        self.layers = nn.ModuleList(ZipformerLayer(d, ff, H, kernel, qd, vd, pd, pos_dim, device)
                                    for _ in range(layers))
        if ds > 1:
            self.downsample = Downsample(ds, device)
            self.out_combiner = Bypass(d, device)

    def forward(self, x, valid, c):
        """``x [B, T, d]`` float32 with ``valid`` frames per row (or None)."""
        T = x.shape[1]
        x0 = x
        if self.ds > 1:
            x = self.downsample(x, valid)
            valid = None if valid is None else -(-valid // self.ds)
        masked_keys, pad = _frames(valid, x.shape[1], x.device, c.dtype)
        pos = compact_positions(x.shape[1], self.pos_dim, x.device).to(c.dtype)
        for layer in self.layers:
            x = layer(x, pos, masked_keys, pad, c)
        if self.ds > 1:
            B, n, d = x.shape  # Up: each frame ds times (no host read of a size)
            x = self.out_combiner(x0, x[:, :, None].expand(B, n, self.ds, d).reshape(
                B, n * self.ds, d)[:, :T])
        return x


def _channels(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` with its channels cut or zero-padded to ``d``."""
    return x[..., :d] if d <= x.shape[-1] else F.pad(x, (0, d - x.shape[-1]))


class ConvEmbed(nn.Module):
    """The 2-D convolutional embedding, ``[B, T, D]`` -> ``[B, T // 2,
    d0]`` float32."""

    def __init__(self, in_dim: int, d0: int, device):
        super().__init__()
        c1, c2, c3 = EMBED_CHANNELS
        self.conv0 = nn.Conv2d(1, c1, 3, padding=(0, 1), device=device)
        self.conv1 = nn.Conv2d(c1, c2, 3, stride=2, device=device)
        self.conv2 = nn.Conv2d(c2, c3, 3, stride=(1, 2), device=device)
        self.convnext_dw = nn.Conv2d(c3, c3, 7, padding=3, groups=c3, device=device)
        self.convnext_pw1 = nn.Conv2d(c3, CONVNEXT_HIDDEN, 1, device=device)
        self.convnext_pw2 = nn.Conv2d(CONVNEXT_HIDDEN, c3, 1, device=device)
        freq = ((in_dim - 3) // 2 + 1 - 3) // 2 + 1
        self.out = nn.Linear(c3 * freq, d0, device=device)
        self.out_norm = BiasNorm(d0, device)

    def forward(self, x, valid, c):
        def conv(layer, h):
            w = c(layer)
            return F.conv2d(h, w.weight, w.bias, layer.stride, layer.padding, groups=layer.groups)

        h = F.pad(x, (0, 0, 0, 7)).to(c.dtype)[:, None]  # [B, 1, T + 7, D]
        h = swoosh_r(conv(self.conv0, h))
        h = swoosh_r(conv(self.conv1, h))
        h = swoosh_r(conv(self.conv2, h))  # [B, c3, T // 2, freq]
        if valid is not None:
            ok = torch.arange(h.shape[2], device=h.device)[None, :] < valid[:, None]
            h = h * ok[:, None, :, None].to(h.dtype)
        h = h + conv(self.convnext_pw2, swoosh_l(conv(self.convnext_pw1,
                                                      conv(self.convnext_dw, h))))
        B, C, T2, Fq = h.shape
        h = h.permute(0, 2, 1, 3).reshape(B, T2, C * Fq)
        return self.out_norm(_dense(c(self.out), h, c.dtype))


def _encode(m, x, lengths):
    """The encoder's forward over the layers of ``m`` (the encoder, or its
    :class:`_Encode`)."""
    B, T, _ = x.shape
    c = Compute(m._products, m.cdt)
    valid = pad = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device).to(torch.int64)
        valid = lengths // 2
        ok = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
        pad = ok[..., None].float()
        x = x * pad
    h = m.embed(x, valid, c)
    outs = []
    for stack in m.stacks:
        h = stack(_channels(h, stack.d), valid, c)
        outs.append(h)
    # the last stack's channels, then each earlier stack's above them
    parts, have = [outs[-1]], m.encoder_dim[-1]
    for out, d in zip(reversed(outs[:-1]), reversed(m.encoder_dim[:-1])):
        if d > have:
            parts.append(out[..., have:d])
            have = d
    h = m.downsample_output(torch.cat(parts, dim=-1), valid)
    v25 = None if valid is None else -(-valid // m.downsample_output.ds)
    h = _gather_frames(h, _clamped(h.shape[1], v25, -(-T // m.up), x.device))
    w = c(m.head_upsample)
    h = F.conv_transpose1d(h.transpose(1, 2).to(c.dtype), w.weight, w.bias,
                           stride=m.head_upsample.stride)[:, :, :T].transpose(1, 2)
    return _dense(c(m.output), _masked(h, pad), c.dtype).float()


class _Encode(nn.Module):
    """The encoder's forward as a module over the encoder's own layers
    (shared, not copied) with no reference back to the encoder: what
    ``make_graphed_callables`` graphs, and patches, in its place."""

    def __init__(self, net: "ZipformerEncoderNet"):
        super().__init__()
        self.embed, self.stacks, self.downsample_output = net.embed, net.stacks, net.downsample_output
        self.head_upsample, self.output = net.head_upsample, net.output
        self.encoder_dim, self.up, self.cdt, self._products = (net.encoder_dim, net.up, net.cdt,
                                                               net._products)

    def forward(self, x, lengths):
        return _encode(self, x, lengths)


class ZipformerEncoderNet(nn.Module):
    """Zipformer hybrid acoustic model ``[B, T, D] -> [B, T, num_classes]``
    logits (float32); the sizes default to Zipformer-L's. With ``lengths``
    padded frames are masked at every rate, so a ragged batch equals each
    utterance scored alone."""

    def __init__(self, num_classes: int, in_dim: int,
                 num_encoder_layers: Sequence[int] = LARGE["num_encoder_layers"],
                 downsampling_factor: Sequence[int] = LARGE["downsampling_factor"],
                 encoder_dim: Sequence[int] = LARGE["encoder_dim"],
                 feedforward_dim: Sequence[int] = LARGE["feedforward_dim"],
                 num_heads: Sequence[int] = LARGE["num_heads"],
                 cnn_module_kernel: Sequence[int] = LARGE["cnn_module_kernel"],
                 query_head_dim: int = 32, value_head_dim: int = 12, pos_head_dim: int = 4,
                 pos_dim: int = 48, output_downsampling_factor: int = 2,
                 compute_dtype: str = "float32", device=None):
        super().__init__()
        device = resolve(device)
        self.num_encoder_layers = tuple(num_encoder_layers)
        self.downsampling_factor = tuple(downsampling_factor)
        self.encoder_dim = tuple(encoder_dim)
        self.embed = ConvEmbed(in_dim, encoder_dim[0], device)
        self.stacks = nn.ModuleList(
            ZipformerStack(ds, n, d, ff, H, k, query_head_dim, value_head_dim, pos_head_dim,
                           pos_dim, device)
            for ds, n, d, ff, H, k in zip(downsampling_factor, num_encoder_layers, encoder_dim,
                                          feedforward_dim, num_heads, cnn_module_kernel))
        self.downsample_output = Downsample(output_downsampling_factor, device)
        width = max(encoder_dim)
        self.up = 2 * output_downsampling_factor  # 25 Hz back to 100 Hz
        self.head_upsample = nn.ConvTranspose1d(width, width, self.up, stride=self.up,
                                                device=device)
        self.output = nn.Linear(width, num_classes, device=device)
        self.cdt = _dtype(compute_dtype)
        #: the layers whose weight and bias are a product's operands
        self._products = [m for m in self.modules() if isinstance(
            m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d))]
        #: (input shape, its training step's graphs) once captured
        self._graphed = None

    @_strict
    def forward(self, x: torch.Tensor, lengths=None, train: bool = False) -> torch.Tensor:
        B, T, _ = x.shape
        T2 = T // 2
        layer_frames = B * sum(n * -(-T2 // ds) for n, ds in
                               zip(self.num_encoder_layers, self.downsampling_factor))
        with profiling.span("zipformer.forward", frames=B * T, layer_frames=layer_frames):
            graphed = self._graph_for(x, lengths)
            return _encode(self, x, lengths) if graphed is None else graphed(x, lengths)

    def _graph_for(self, x, lengths):
        """A training step's forward and backward at ``x``'s shape as two
        CUDA graphs (``torch.cuda.make_graphed_callables``), captured at
        the first call with gradients and lengths on the card and replayed
        for every call at that shape, that first one included. Before the
        capture one eager forward and backward warms cuBLAS, cuDNN and the
        allocator; its gradients go nowhere (``torch.autograd.grad``, not
        the parameters' ``.grad``) and the allocator's cache is emptied
        after it. One shape's graphs at most, since their memory pool
        holds a step's activations: other shapes, and calls without a
        card, gradients or lengths, run eagerly (None). At a training
        step's ~6,800 launches the host's dispatch, not the card, would
        set the step's time.

        This belongs in the trainer, for every network it trains; it
        goes from here once ``SequenceTrainer`` graphs its own step."""
        if not (x.is_cuda and torch.is_grad_enabled() and lengths is not None):
            return None
        if self._graphed is None:
            # the graphs' own input buffers, which each replay's inputs are copied into
            step, x = _Encode(self), x.detach().clone()
            lengths = torch.as_tensor(lengths, device=x.device).clone()
            out = step(x, lengths)
            torch.autograd.grad(out, [p for p in step.parameters() if p.requires_grad],
                                torch.ones_like(out), allow_unused=True)
            del out
            torch.cuda.synchronize(x.device)
            torch.cuda.empty_cache()
            self._graphed = (tuple(x.shape), torch.cuda.make_graphed_callables(
                step, (x, lengths), num_warmup_iters=0))
        shape, graphed = self._graphed
        return graphed if tuple(x.shape) == shape else None
