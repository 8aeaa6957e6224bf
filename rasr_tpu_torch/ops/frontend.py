"""Batched acoustic feature frontend (MFCC / splice / LDA) in PyTorch.

Counterpart of ``rasr_tpu/ops/frontend.py``: whole padded utterance
batches ``[B, S]`` map to feature tensors ``[B, T, D]``. The basis maths
(window, real-DFT bases, mel filterbank, DCT, liftering) is the same
numpy code; the tensor functions are torch and take their device from
their inputs.

On a CUDA tensor :class:`FeatureFrontend` computes the cepstra with the
hand-written fused kernel (``ops/kernels/mfcc.py``); on a CPU tensor it
uses the plain :func:`mfcc_from_frames`. CMVN, splice and the LDA
projection sit outside any kernel in the reference too and stay plain
torch.

Off the ported path for now (they raise ``NotImplementedError``):
sliding-window CMVN, deltas, ``append_energy`` and VTLN warping.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .kernels.mfcc import folded_bases, mfcc_frames


# --------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Static frontend hyperparameters (same fields and defaults as the
    reference: 25ms/10ms Hamming frames, preemphasis 1.0, 20 mel bands,
    16 cepstra, per-segment mean/variance normalization)."""

    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemphasis: float = 1.0
    window: str = "hamming"  # hamming | hanning | rectangular
    fft_size: int = 0  # 0 = next pow2 >= frame_length
    use_matmul_dft: bool = True
    num_mel: int = 20
    fmin: float = 0.0
    fmax: float = 0.0  # 0 = nyquist
    num_cepstra: int = 16
    dct_norm: str = "rasr"  # rasr | ortho
    cep_lifter: float = 0.0
    log_floor: float = 1e-10
    append_energy: bool = False
    normalize: str = "segment"  # none | segment | sliding
    norm_variance: bool = True
    norm_window: int = 300

    @property
    def frame_length(self) -> int:
        return int(round(self.sample_rate * self.frame_length_ms / 1000.0))

    @property
    def frame_shift(self) -> int:
        return int(round(self.sample_rate * self.frame_shift_ms / 1000.0))

    @property
    def padded_fft_size(self) -> int:
        if self.fft_size:
            return self.fft_size
        n = 1
        while n < self.frame_length:
            n *= 2
        return n

    @property
    def num_bins(self) -> int:
        return self.padded_fft_size // 2 + 1

    @property
    def output_dim(self) -> int:
        return self.num_cepstra + (1 if self.append_energy else 0)


# ----------------------------------------------------------------- basis math
def window_function(kind: str, length: int) -> np.ndarray:
    n = np.arange(length)
    if kind == "hamming":
        return (0.54 - 0.46 * np.cos(2 * np.pi * n / (length - 1))).astype(np.float32)
    if kind == "hanning":
        return (0.5 - 0.5 * np.cos(2 * np.pi * n / (length - 1))).astype(np.float32)
    if kind == "rectangular":
        return np.ones(length, np.float32)
    raise ValueError(f"unknown window {kind!r}")


def dft_matrices(frame_length: int, fft_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases ``[frame_length, num_bins]``: power[k] =
    (x.C)[k]^2 + (x.S)[k]^2 (zero-padding to fft_size is implicit)."""
    bins = fft_size // 2 + 1
    t = np.arange(frame_length)[:, None]
    k = np.arange(bins)[None, :]
    ang = 2.0 * np.pi * t * k / fft_size
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(
    num_mel: int, num_bins: int, fft_size: int, sample_rate: int,
    fmin: float = 0.0, fmax: float = 0.0,
) -> np.ndarray:
    """HTK-style triangular mel filterbank, shape ``[num_bins, num_mel]``."""
    if fmax <= 0.0:
        fmax = sample_rate / 2.0
    mel_points = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mel + 2)
    hz_points = mel_to_hz(mel_points)
    bin_freqs = np.arange(num_bins) * sample_rate / fft_size
    fb = np.zeros((num_bins, num_mel), np.float32)
    for m in range(num_mel):
        lo, ctr, hi = hz_points[m], hz_points[m + 1], hz_points[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dct_matrix(num_mel: int, num_cepstra: int, norm: str = "rasr") -> np.ndarray:
    """DCT-II basis ``[num_mel, num_cepstra]`` (cepstrum extraction)."""
    m = np.arange(num_mel)[:, None]
    k = np.arange(num_cepstra)[None, :]
    basis = np.cos(np.pi * k * (2 * m + 1) / (2.0 * num_mel))
    if norm == "ortho":
        basis *= np.sqrt(2.0 / num_mel)
        basis[:, 0] *= 1.0 / np.sqrt(2.0)
    else:
        basis *= 2.0 / num_mel
    return basis.astype(np.float32)


def lifter_coeffs(num_cepstra: int, lifter: float) -> np.ndarray:
    """Sinusoidal liftering coefficients ``[C]`` (identity for lifter<=0)."""
    if lifter <= 0:
        return np.ones(num_cepstra, np.float32)
    k = np.arange(num_cepstra)
    return (1.0 + lifter / 2.0 * np.sin(np.pi * k / lifter)).astype(np.float32)


# ------------------------------------------------------------------ parameters
@dataclasses.dataclass(frozen=True)
class FrontendParams:
    """Constant basis tensors of the frontend."""

    window: torch.Tensor  # [L]
    dft_cos: torch.Tensor  # [L, K]
    dft_sin: torch.Tensor  # [L, K]
    mel: torch.Tensor  # [K, M]
    dct: torch.Tensor  # [M, C]

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def to(self, device) -> "FrontendParams":
        return FrontendParams(*(t.to(device) for t in self.tensors()))


def make_params(cfg: FrontendConfig, device="cpu") -> FrontendParams:
    cos_b, sin_b = dft_matrices(cfg.frame_length, cfg.padded_fft_size)
    mel = mel_filterbank(
        cfg.num_mel, cfg.num_bins, cfg.padded_fft_size, cfg.sample_rate,
        cfg.fmin, cfg.fmax,
    )
    dct = (
        dct_matrix(cfg.num_mel, cfg.num_cepstra, cfg.dct_norm)
        * lifter_coeffs(cfg.num_cepstra, cfg.cep_lifter)[None, :]
    )
    arrays = (window_function(cfg.window, cfg.frame_length), cos_b, sin_b, mel, dct)
    return FrontendParams(*(torch.as_tensor(a, device=device) for a in arrays))


# ------------------------------------------------------------------- pipeline
def num_frames(num_samples: int, cfg: FrontendConfig) -> int:
    """Frames fully covered by the signal (no partial tail frames)."""
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def preemphasize(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """y[t] = x[t] - alpha*x[t-1]; x[0] is kept (zero history)."""
    if alpha == 0.0:
        return x
    shifted = torch.nn.functional.pad(x[..., :-1], (1, 0))
    return x - alpha * shifted


def frame_signal(x: torch.Tensor, max_frames: int, cfg: FrontendConfig) -> torch.Tensor:
    """[..., S] -> [..., max_frames, frame_length] strided framing (a view
    of the padded signal: no frame is copied)."""
    L, H = cfg.frame_length, cfg.frame_shift
    needed = (max_frames - 1) * H + L if max_frames > 0 else L
    pad = max(0, needed - x.shape[-1])
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x[..., :needed].unfold(-1, L, H)[..., :max_frames, :]


def power_spectrum(
    frames: torch.Tensor, params: FrontendParams, cfg: FrontendConfig
) -> torch.Tensor:
    """[..., T, L] -> [..., T, K] power spectrum (matmul-DFT or rfft)."""
    windowed = frames * params.window
    if cfg.use_matmul_dft:
        re = torch.matmul(windowed, params.dft_cos)
        im = torch.matmul(windowed, params.dft_sin)
        return re * re + im * im
    spec = torch.fft.rfft(windowed, n=cfg.padded_fft_size, dim=-1)
    return spec.abs().to(torch.float32) ** 2


def mfcc_from_frames(
    frames: torch.Tensor, params: FrontendParams, cfg: FrontendConfig
) -> torch.Tensor:
    """[..., T, L] windowing -> power -> mel -> log -> DCT = [..., T, C]
    (the plain version of the fused MFCC kernel)."""
    if cfg.append_energy:
        raise NotImplementedError("append_energy is not ported yet")
    power = power_spectrum(frames, params, cfg)
    mel_energies = torch.matmul(power, params.mel)
    log_mel = torch.log(torch.clamp(mel_energies, min=cfg.log_floor))
    return torch.matmul(log_mel, params.dct)


def cmvn(
    feats: torch.Tensor, frame_mask: torch.Tensor, norm_variance: bool = True,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Per-segment mean (and variance) normalization over valid frames.
    feats ``[..., T, D]``, frame_mask ``[..., T]`` (1 = valid)."""
    mask = frame_mask[..., None]
    count = torch.clamp(mask.sum(dim=-2, keepdim=True), min=1.0)
    mean = (feats * mask).sum(dim=-2, keepdim=True) / count
    out = (feats - mean) * mask
    if norm_variance:
        var = (out * out * mask).sum(dim=-2, keepdim=True) / count
        out = out * torch.rsqrt(var + eps)
    return out


def sliding_cmvn(*args, **kwargs):
    raise NotImplementedError("sliding-window CMVN is not ported yet")


def deltas(*args, **kwargs):
    raise NotImplementedError("delta features are not ported yet")


def edge_fill(feats: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
    """Replace padding frames with each row's LAST VALID frame
    (``feats [B, T, D]``, ``n_frames [B]``), so splice's clipped context
    windows replicate the true segment edge instead of batch padding.
    Rows with ``n == 0`` fill from frame 0."""
    T = feats.shape[-2]
    tidx = torch.minimum(
        torch.arange(T, device=feats.device)[None, :],
        torch.clamp(n_frames.to(torch.int64) - 1, min=0)[:, None],
    )  # [B, T]
    return torch.gather(feats, 1, tidx[..., None].expand(-1, -1, feats.shape[-1]))


def splice(feats: torch.Tensor, context: int) -> torch.Tensor:
    """[..., T, D] -> [..., T, (2*context+1)*D] with edge replication."""
    T = feats.shape[-2]
    pieces = []
    for off in range(-context, context + 1):
        idx = torch.clamp(torch.arange(T, device=feats.device) + off, 0, T - 1)
        pieces.append(feats[..., idx, :])
    return torch.cat(pieces, dim=-1)


def apply_lda(feats: torch.Tensor, lda: torch.Tensor) -> torch.Tensor:
    """Project spliced features with an LDA matrix ``[D_in, D_out]``."""
    return torch.matmul(feats, lda)


# ------------------------------------------------------------------- frontend
class FeatureFrontend(nn.Module):
    """End-to-end batched frontend: samples -> (spliced + LDA'd) features.

    ``forward(samples [B, S], lengths [B])`` returns ``(feats [B, T, D],
    n_frames [B])`` on the module's device. On CUDA the cepstra come from
    the fused MFCC kernel; on the CPU from the plain version. ``params``
    overrides the bases computed from ``cfg`` (e.g. carried across from
    the JAX frontend by ``convert.frontend_params_from_jax``).
    """

    def __init__(
        self,
        cfg: FrontendConfig = FrontendConfig(),
        splice_context: int = 0,
        lda: Optional[np.ndarray] = None,
        delta_order: int = 0,
        vtln_warp: Optional[np.ndarray] = None,
        device="cpu",
        params: Optional[FrontendParams] = None,
    ):
        super().__init__()
        if delta_order:
            raise NotImplementedError("delta features are not ported yet")
        if vtln_warp is not None:
            raise NotImplementedError("VTLN warping is not ported yet")
        if cfg.normalize == "sliding":
            raise NotImplementedError("sliding-window CMVN is not ported yet")
        if cfg.append_energy:
            raise NotImplementedError("append_energy is not ported yet")
        self.cfg = cfg
        self.splice_context = splice_context
        params = make_params(cfg, device) if params is None else params.to(device)
        for f, t in zip(dataclasses.fields(params), params.tensors()):
            self.register_buffer(f.name, t)
        cosw, sinw = folded_bases(params)
        self.register_buffer("cosw", cosw)
        self.register_buffer("sinw", sinw)
        if lda is None:
            self.lda = None
        else:
            self.register_buffer("lda", torch.as_tensor(np.array(lda, np.float32), device=device))

    @property
    def params(self) -> FrontendParams:
        return FrontendParams(self.window, self.dft_cos, self.dft_sin, self.mel, self.dct)

    @property
    def output_dim(self) -> int:
        d = self.cfg.output_dim
        if self.splice_context:
            d *= 2 * self.splice_context + 1
        if self.lda is not None:
            d = self.lda.shape[1]
        return d

    def forward(
        self, samples: torch.Tensor, lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        dev = self.window.device
        samples = torch.as_tensor(samples, dtype=torch.float32, device=dev)
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
        max_frames = num_frames(samples.shape[-1], cfg)
        x = preemphasize(samples, cfg.preemphasis)
        frames = frame_signal(x, max_frames, cfg)
        if frames.is_cuda:
            feats = mfcc_frames(frames, self.cosw, self.sinw, self.mel, self.dct,
                                cfg.log_floor)
        else:
            feats = mfcc_from_frames(frames, self.params, cfg)
        n_frames = torch.where(
            lengths >= cfg.frame_length,
            1 + torch.div(lengths - cfg.frame_length, cfg.frame_shift, rounding_mode="floor"),
            torch.zeros_like(lengths),
        )
        # lengths beyond the sample buffer claim no uncomputed frames
        n_frames = torch.clamp(n_frames, max=max_frames)
        mask = (
            torch.arange(max_frames, device=dev)[None, :] < n_frames[:, None]
        ).to(torch.float32)
        if cfg.normalize == "segment":
            feats = cmvn(feats, mask, cfg.norm_variance)
        if self.splice_context:
            feats = edge_fill(feats, n_frames)
            feats = splice(feats, self.splice_context)
        if self.lda is not None:
            feats = apply_lda(feats, self.lda)
        feats = feats * mask[..., None]
        return feats, n_frames
