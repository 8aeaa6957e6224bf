"""MFCC, segment CMVN, splice and LDA of one utterance, in float64 NumPy.

The spectrum is a real FFT (``numpy.fft.rfft``), not the DFT product the
port's kernel computes; mel filterbank and DCT follow the configuration
(HTK-style triangles on the mel scale, RASR's DCT-II scaled by 2 / bands).
"""

from __future__ import annotations

import numpy as np


def _mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def shapes(cfg: dict):
    """(frame length, shift, FFT size) in samples."""
    f, sr = cfg["frontend"], cfg["sample_rate"]
    L = int(round(sr * f["frame_length_ms"] / 1000.0))
    H = int(round(sr * f["frame_shift_ms"] / 1000.0))
    n = 1
    while n < L:
        n *= 2
    return L, H, n


def num_frames(num_samples: int, cfg: dict) -> int:
    L, H, _ = shapes(cfg)
    return 0 if num_samples < L else 1 + (num_samples - L) // H


def filterbank(cfg: dict) -> np.ndarray:
    f, sr = cfg["frontend"], cfg["sample_rate"]
    _, _, nfft = shapes(cfg)
    bins, M = nfft // 2 + 1, f["num_mel"]
    hz = _hz(np.linspace(_mel(0.0), _mel(sr / 2.0), M + 2))
    freq = np.arange(bins) * sr / nfft
    fb = np.zeros((bins, M))
    for m in range(M):
        up = (freq - hz[m]) / max(hz[m + 1] - hz[m], 1e-9)
        down = (hz[m + 2] - freq) / max(hz[m + 2] - hz[m + 1], 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dct(cfg: dict) -> np.ndarray:
    M, C = cfg["frontend"]["num_mel"], cfg["frontend"]["num_cepstra"]
    m = np.arange(M)[:, None]
    k = np.arange(C)[None, :]
    return np.cos(np.pi * k * (2 * m + 1) / (2.0 * M)) * (2.0 / M)


def cepstra(samples: np.ndarray, cfg: dict) -> np.ndarray:
    """``[n, num_cepstra]`` log-mel cepstra of one utterance's samples."""
    f = cfg["frontend"]
    L, H, nfft = shapes(cfg)
    x = np.asarray(samples, np.float64)
    x = x - f["preemphasis"] * np.concatenate([[0.0], x[:-1]])
    n = num_frames(x.shape[0], cfg)
    frames = x[np.arange(n)[:, None] * H + np.arange(L)[None, :]]
    window = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(L) / (L - 1))
    power = np.abs(np.fft.rfft(frames * window, n=nfft, axis=-1)) ** 2
    logmel = np.log(np.maximum(power @ filterbank(cfg), f["log_floor"]))
    return logmel @ dct(cfg)


def features(samples: np.ndarray, lda: np.ndarray, cfg: dict) -> np.ndarray:
    """``[n, feat_dim]``: cepstra, mean and variance normalized over the
    segment, spliced over +-context frames (edges repeated), projected."""
    c = cepstra(samples, cfg)
    c = c - c.mean(axis=0)
    c = c / np.sqrt((c * c).mean(axis=0) + 1e-8)
    ctx = cfg["frontend"]["splice_context"]
    n = c.shape[0]
    idx = np.clip(np.arange(n)[:, None] + np.arange(-ctx, ctx + 1)[None, :], 0, n - 1)
    spliced = c[idx].reshape(n, -1)
    return spliced @ np.asarray(lda, np.float64)


def features_lowered(samples, lda: np.ndarray, cfg: dict, quant):
    """:func:`features` in float32 with the operands of the mel, DCT and
    LDA products rounded by ``quant``: the lower-precision control."""
    import torch

    f = cfg["frontend"]
    L, H, nfft = shapes(cfg)
    x = torch.as_tensor(samples, dtype=torch.float32)
    x = x - f["preemphasis"] * torch.cat([x.new_zeros(1), x[:-1]])
    n = num_frames(x.shape[0], cfg)
    frames = x[torch.arange(n, device=x.device)[:, None] * H + torch.arange(L, device=x.device)]
    win = torch.as_tensor(0.54 - 0.46 * np.cos(2 * np.pi * np.arange(L) / (L - 1)),
                          dtype=torch.float32, device=x.device)
    power = torch.fft.rfft(frames * win, n=nfft, dim=-1).abs() ** 2

    def mm(a, b):
        return quant(a) @ quant(torch.as_tensor(b, dtype=torch.float32, device=a.device))

    c = mm(torch.log(torch.clamp(mm(power, filterbank(cfg)), min=f["log_floor"])), dct(cfg))
    c = c - c.mean(0)
    c = c / torch.sqrt((c * c).mean(0) + 1e-8)
    ctx = f["splice_context"]
    idx = torch.clamp(torch.arange(n, device=x.device)[:, None]
                      + torch.arange(-ctx, ctx + 1, device=x.device), 0, n - 1)
    return mm(c[idx].reshape(n, -1), lda)
