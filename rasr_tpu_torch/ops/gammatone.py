"""Gammatone filterbank frontend and the VTLN frequency warp.

Counterpart of ``rasr_tpu/ops/gammatone.py`` (the RWTH "GT features": a
4th-order gammatone filterbank on an ERB scale as FIR convolutions,
Hanning-weighted temporal integration of the channel energies, 10th-root
compression, an optional DCT). The filter maths is the same numpy code.

The temporal integration is a strided 1-D convolution of the energies
with the Hanning window: the reference gathers every frame's window of
samples first (``[B, C, T, Lw]``, 5.1 GB at 64 x 10 s, 50 channels and a
400-sample window) and sums it; the convolution computes the same sums
without that copy. The channel filtering runs without TF32 (cuDNN's
default allows it for float32 convolutions), so the card follows the
CPU. The reference has no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve
from ..models.nn import strict_precision
from .frontend import dct_matrix


def erb_scale(f: np.ndarray) -> np.ndarray:
    return 21.4 * np.log10(1 + 0.00437 * f)


def inverse_erb_scale(e: np.ndarray) -> np.ndarray:
    return (10 ** (np.asarray(e) / 21.4) - 1) / 0.00437


def gammatone_kernels(
    num_channels: int,
    sample_rate: int,
    kernel_ms: float = 16.0,
    fmin: float = 100.0,
    fmax: float = 0.0,
    order: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """FIR gammatone impulse responses ``[num_channels, L]`` (unit energy)
    and their centre frequencies, equally spaced on the ERB scale."""
    if fmax <= 0:
        fmax = sample_rate / 2.0
    centers = inverse_erb_scale(
        np.linspace(erb_scale(np.array(fmin)), erb_scale(np.array(fmax)), num_channels)
    )
    L = int(sample_rate * kernel_ms / 1000.0)
    t = np.arange(L) / sample_rate
    kernels = np.zeros((num_channels, L), np.float32)
    for c, fc in enumerate(centers):
        erb = 24.7 * (4.37 * fc / 1000.0 + 1.0)
        b = 1.019 * erb
        env = t ** (order - 1) * np.exp(-2 * np.pi * b * t)
        peak = env.max()
        if peak > 0:
            env = env / peak  # rescale first: wide channels underflow when squared
        kern = env * np.cos(2 * np.pi * fc * t)
        norm = np.sqrt(np.sum(kern**2))
        if norm > 0:
            kern = kern / norm
        kernels[c] = kern
    return kernels, centers


@dataclasses.dataclass(frozen=True)
class GammatoneConfig:
    sample_rate: int = 16000
    num_channels: int = 50
    kernel_ms: float = 16.0
    fmin: float = 100.0
    frame_shift_ms: float = 10.0
    integration_ms: float = 25.0
    compression: float = 0.1  # 10th root
    num_outputs: int = 0  # DCT outputs; 0 = channels (no DCT)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def integration_length(self) -> int:
        return int(self.sample_rate * self.integration_ms / 1000.0)


class GammatoneFrontend(nn.Module):
    """``forward(samples [B, S], lengths [B])`` -> (gammatone features
    ``[B, T, C or num_outputs]``, frame counts ``[B]``) on the module's
    device (the card unless ``device`` names another)."""

    def __init__(self, cfg: GammatoneConfig = GammatoneConfig(), device=None):
        super().__init__()
        device = resolve(device)
        self.cfg = cfg
        kernels, self.centers = gammatone_kernels(
            cfg.num_channels, cfg.sample_rate, cfg.kernel_ms, cfg.fmin
        )
        self.register_buffer("kernels", torch.as_tensor(kernels, device=device))
        win = np.hanning(cfg.integration_length).astype(np.float32)
        self.register_buffer("int_window", torch.as_tensor(win / win.sum(), device=device))
        if cfg.num_outputs:
            dct = dct_matrix(cfg.num_channels, cfg.num_outputs, "ortho")
            self.register_buffer("dct", torch.as_tensor(dct, device=device))
        else:
            self.dct = None

    @property
    def output_dim(self) -> int:
        return self.cfg.num_outputs or self.cfg.num_channels

    def num_frames(self, num_samples: int) -> int:
        L = self.cfg.integration_length
        if num_samples < L:
            return 0
        return 1 + (num_samples - L) // self.cfg.frame_shift

    def forward(
        self, samples: torch.Tensor, lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        dev = self.kernels.device
        x = torch.as_tensor(samples, dtype=torch.float32, device=dev)
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
        B, S = x.shape
        C, Lk = self.kernels.shape
        H, Lw = cfg.frame_shift, cfg.integration_length
        max_frames = self.num_frames(S)
        with strict_precision():
            # causal channel filtering: [B, 1, S] * [C, 1, Lk] -> [B, C, S]
            y = torch.nn.functional.conv1d(
                torch.nn.functional.pad(x[:, None, :], (Lk - 1, 0)), self.kernels[:, None, :]
            )
            energy = (y * y).reshape(B * C, 1, S)
            del y
            # temporal integration: the Hanning-weighted sum over each
            # frame's window, sampled at the frame shift (at least one
            # window's worth of input, also for a signal with no frame)
            pad = max(0, (max(max_frames, 1) - 1) * H + Lw - S)
            if pad:
                energy = torch.nn.functional.pad(energy, (0, pad))
            integrated = torch.nn.functional.conv1d(energy, self.int_window[None, None, :],
                                                    stride=H)
        integrated = integrated[:, 0, :max_frames].reshape(B, C, max_frames).transpose(1, 2)
        feats = torch.pow(torch.clamp(integrated, min=1e-10), cfg.compression)
        if self.dct is not None:
            feats = torch.matmul(feats, self.dct)
        n_frames = torch.where(
            lengths >= Lw,
            1 + torch.div(lengths - Lw, H, rounding_mode="floor"),
            torch.zeros_like(lengths),
        )
        n_frames = torch.clamp(n_frames, max=max_frames)
        mask = (torch.arange(max_frames, device=dev)[None, :] < n_frames[:, None]).to(feats.dtype)
        return feats * mask[..., None], n_frames


# ----------------------------------------------------------------------- VTLN
def piecewise_linear_warp(
    num_bins: int, alpha: float, boundary: float = 0.875
) -> np.ndarray:
    """VTLN warping matrix ``[num_bins, num_bins]``: frequencies below
    ``boundary`` x Nyquist scale by alpha, a linear segment maps the rest
    onto the remaining range, and each target bin interpolates its two
    source bins (applied on the power spectrum before the mel filterbank)."""
    warp = np.zeros((num_bins, num_bins), np.float32)
    for k in range(num_bins):
        f = k / (num_bins - 1)  # normalized target frequency
        if f < boundary:
            src = f / alpha
        else:
            lo_t, lo_s = boundary, boundary / alpha
            src = lo_s + (f - lo_t) * (1.0 - lo_s) / max(1.0 - lo_t, 1e-6)
        src_bin = src * (num_bins - 1)
        i0 = int(np.clip(np.floor(src_bin), 0, num_bins - 1))
        i1 = min(i0 + 1, num_bins - 1)
        frac = src_bin - i0
        if 0 <= i0 < num_bins:
            warp[i0, k] += 1.0 - frac
            warp[i1, k] += frac
    return warp


def apply_vtln(power_spectrum: torch.Tensor, warp_matrix: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K, K] -> warped spectrum."""
    return torch.matmul(power_spectrum, warp_matrix)
