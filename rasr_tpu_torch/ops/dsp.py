"""Miscellaneous DSP ops: energy, silence detection, FIR filtering, delay,
spectral analysis, normalization and noise estimation.

Counterpart of ``rasr_tpu/ops/dsp.py``: batched tensor functions over
``[B, T, ...]`` (the reference's remaining Signal flow nodes). They take
their device from their inputs; the reference has no Pallas kernel here.
"""

from __future__ import annotations

import numpy as np
import torch


def frame_energy(frames: torch.Tensor, log: bool = True, floor: float = 1e-10) -> torch.Tensor:
    """Per-frame energy of framed samples ``[..., T, L]`` -> ``[..., T]``."""
    e = torch.sum(frames * frames, dim=-1)
    if log:
        e = torch.log(torch.clamp(e, min=floor))
    return e


def silence_detection(
    energy: torch.Tensor,
    frame_mask: torch.Tensor,
    threshold_db: float = 30.0,
    hangover: int = 5,
) -> torch.Tensor:
    """Energy-based speech/silence classification per frame: speech is
    within ``threshold_db`` of the segment's peak energy, and speech runs
    grow by ``hangover`` frames on both sides. energy ``[..., T]`` (log,
    nats), frame_mask ``[..., T]`` 1 = valid; returns 1.0 = speech."""
    neg = torch.where(frame_mask > 0, energy, -torch.inf)
    peak = torch.amax(neg, dim=-1, keepdim=True)
    thresh_nats = threshold_db * (np.log(10.0) / 10.0)
    speech = (neg > peak - thresh_nats).to(torch.float32)
    if hangover > 0:
        # dilate the speech mask by +-hangover (a max pool)
        T = speech.shape[-1]
        idx = np.arange(T)[:, None] + np.arange(-hangover, hangover + 1)[None, :]
        idx = torch.as_tensor(np.clip(idx, 0, T - 1), device=speech.device)
        speech = torch.amax(speech[..., idx], dim=-1)
    return speech * frame_mask


def fir_filter(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Causal FIR filtering along the last axis; ``taps [ntaps]``, tap 0
    the current sample."""
    taps = torch.as_tensor(np.asarray(taps), dtype=x.dtype, device=x.device)
    n = taps.shape[0]
    xp = torch.nn.functional.pad(x, (n - 1, 0))
    win = xp.unfold(-1, n, 1)  # [..., S, n]
    return torch.matmul(win, taps.flip(0))


def delay(x: torch.Tensor, frames: int) -> torch.Tensor:
    """Shift along the last axis by ``frames`` (positive = delay),
    zero-filled."""
    if frames == 0:
        return x
    if frames > 0:
        return torch.nn.functional.pad(x, (frames, 0))[..., : x.shape[-1]]
    return torch.nn.functional.pad(x, (0, -frames))[..., -frames:]


# ---------------------------------------------------------- spectral analysis
def _fft_size(n: int) -> int:
    size = 1
    while size < 2 * n:
        size *= 2
    return size


def autocorrelation(frames: torch.Tensor, max_lag: int) -> torch.Tensor:
    """Per-frame autocorrelation r[0..max_lag] through the zero-padded
    power spectrum: ``[..., T, L]`` -> ``[..., T, max_lag + 1]``."""
    n = _fft_size(frames.shape[-1])
    spec = torch.fft.rfft(frames, n=n, dim=-1)
    r = torch.fft.irfft(spec * torch.conj(spec), n=n, dim=-1)
    return r[..., : max_lag + 1]


def levinson(r: torch.Tensor, order: int):
    """Levinson-Durbin recursion: autocorrelation ``[..., order+1]`` ->
    (LPC coefficients ``[..., order]`` with x_t ~ sum_k a[k] x_{t-k},
    reflection coefficients ``[..., order]``, prediction-error power
    ``[...]``), unrolled over the (small, fixed) order."""
    eps = 1e-8
    a = torch.zeros(r.shape[:-1] + (order,), dtype=r.dtype, device=r.device)
    k_out = []
    err = r[..., 0] + eps
    for m in range(order):
        acc = r[..., m + 1]
        for i in range(m):
            acc = acc - a[..., i] * r[..., m - i]
        k = acc / err
        k_out.append(k)
        # a_new[i] = a[i] - k * a[m-1-i]
        a = a.clone()
        if m > 0:
            a[..., :m] = a[..., :m] - k[..., None] * a[..., :m].flip(-1)
        a[..., m] = k
        err = err * (1.0 - k * k)
    return a, torch.stack(k_out, dim=-1), err


def zero_crossing_rate(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame zero-crossing rate in [0, 1]: ``[..., T, L]`` ->
    ``[..., T]``."""
    s = torch.sign(frames)
    flips = torch.abs(s[..., 1:] - s[..., :-1]) > 1.0
    return torch.mean(flips.to(torch.float32), dim=-1)


def spectral_moments(power: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Spectral centroid and spread (Hz) of power spectra ``[..., T, F]``
    -> ``[..., T, 2]``."""
    F = power.shape[-1]
    freqs = torch.as_tensor(
        np.linspace(0.0, sample_rate / 2.0, F, dtype=np.float32), device=power.device
    )
    mass = torch.clamp(power.sum(dim=-1, keepdim=True), min=1e-10)
    p = power / mass
    centroid = torch.sum(p * freqs, dim=-1)
    spread = torch.sqrt(torch.clamp(torch.sum(p * freqs**2, dim=-1) - centroid**2, min=0.0))
    return torch.stack([centroid, spread], dim=-1)


def harmonic_sum_pitch(
    power: torch.Tensor,
    sample_rate: float,
    fft_size: int,
    fmin: float = 60.0,
    fmax: float = 400.0,
    num_harmonics: int = 5,
) -> torch.Tensor:
    """Harmonic-sum pitch and voicedness per frame: for each candidate f0
    bin the harmonic sum over ``num_harmonics`` (each harmonic +-1 bin
    with triangular weights, one product with a constant selection
    matrix); the argmax is the pitch, the peak's share of the frame
    energy the voicedness. ``[..., T, F]`` -> ``[..., T, 2]``."""
    F = power.shape[-1]
    hz_per_bin = sample_rate / fft_size
    cand = np.arange(max(int(fmin / hz_per_bin), 1), int(fmax / hz_per_bin) + 1)
    if cand.size == 0:
        raise ValueError("empty pitch candidate range")
    harm = np.minimum(cand[:, None] * np.arange(1, num_harmonics + 1)[None, :], F - 1)
    sel = np.zeros((F, cand.size), np.float32)
    for c in range(cand.size):
        for h in harm[c]:
            h = int(h)
            sel[h, c] += 1.0
            if h > 0:
                sel[h - 1, c] += 0.5
            if h < F - 1:
                sel[h + 1, c] += 0.5
    hsum = torch.matmul(power, torch.as_tensor(sel, device=power.device))  # [..., T, C]
    best = torch.argmax(hsum, dim=-1)
    f0 = torch.as_tensor(cand.astype(np.float32) * hz_per_bin, device=power.device)[best]
    total = torch.clamp(power.sum(dim=-1), min=1e-10)
    peak = torch.amax(hsum, dim=-1)
    voiced = torch.clamp(peak / (num_harmonics * total), 0.0, 1.0)
    return torch.stack([f0, voiced], dim=-1)


# ------------------------------------------------------------- normalization
def histogram_normalization(
    feats: torch.Tensor,
    frame_mask: torch.Tensor,
    num_quantiles: int = 16,
) -> torch.Tensor:
    """Quantile-based normalization: per segment and dimension, a monotone
    piecewise-linear map of the empirical quantiles onto the standard
    normal's. feats ``[B, T, D]``, frame_mask ``[B, T]``."""
    from scipy.stats import norm as _norm  # host-side targets only

    dev = feats.device
    qs = np.linspace(0.02, 0.98, num_quantiles, dtype=np.float32)
    targets = torch.as_tensor(_norm.ppf(qs).astype(np.float32), device=dev)  # [Q]
    masked = torch.where(frame_mask[..., None] > 0, feats, torch.tensor(3.4e38, device=dev))
    T = feats.shape[1]
    n = torch.clamp(frame_mask.sum(dim=1), min=1.0)  # [B]
    srt = torch.sort(masked, dim=1).values  # valid frames first
    pos = torch.as_tensor(qs, device=dev)[None, :] * (n[:, None] - 1.0)  # [B, Q]
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, T - 1)
    hi = torch.clamp(lo + 1, 0, T - 1)
    frac = (pos - lo.to(pos.dtype))[..., None]
    D = feats.shape[2]

    def take(idx):
        return torch.gather(srt, 1, idx[..., None].expand(-1, -1, D))

    qv = (1.0 - frac) * take(lo) + frac * take(hi)  # [B, Q, D]
    qv = qv.transpose(1, 2)  # [B, D, Q]
    x = feats.transpose(1, 2)  # [B, D, T]
    idx = (x[..., None] >= qv[..., None, :]).to(torch.int64).sum(dim=-1)  # [B, D, T]
    i1 = torch.clamp(idx, 1, num_quantiles - 1)
    q_lo = torch.gather(qv, -1, i1 - 1)
    q_hi = torch.gather(qv, -1, i1)
    t_lo = targets[i1 - 1]
    t_hi = targets[i1]
    w = torch.clamp((x - q_lo) / torch.clamp(q_hi - q_lo, min=1e-6), -1.0, 2.0)
    out = t_lo + w * (t_hi - t_lo)
    return out.transpose(1, 2) * frame_mask[..., None]


def normalize_energy(energy: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
    """Log-energy minus the segment's peak (speech ~ 0, silence below)."""
    peak = torch.amax(torch.where(frame_mask > 0, energy, -torch.inf), dim=-1, keepdim=True)
    return (energy - peak) * frame_mask


# ------------------------------------------------------------ noise / misc
def noise_estimate(
    power: torch.Tensor, frame_mask: torch.Tensor, quantile: float = 0.1
) -> torch.Tensor:
    """Per-bin noise floor: the mean of the lowest-energy ``quantile`` of
    the valid frames. power ``[B, T, F]`` -> ``[B, F]``."""
    e = power.sum(dim=-1)
    e = torch.where(frame_mask > 0, e, torch.inf)
    T = power.shape[1]
    k = max(int(T * quantile), 1)
    neg, idx = torch.topk(-e, k, dim=-1)  # lowest-energy frames
    sel = torch.gather(power, 1, idx[..., None].expand(-1, -1, power.shape[-1]))
    valid = (-neg < torch.inf)[..., None]
    return torch.where(valid, sel, 0.0).sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1)


def spectral_subtraction(
    power: torch.Tensor,
    noise: torch.Tensor,
    over_subtraction: float = 1.0,
    floor: float = 0.01,
) -> torch.Tensor:
    """Power spectral subtraction with flooring. power ``[B, T, F]``,
    noise ``[B, F]``."""
    clean = power - over_subtraction * noise[:, None, :]
    return torch.maximum(clean, floor * power)


def dc_detection(
    samples: torch.Tensor, lengths: torch.Tensor, window: int = 160,
    threshold: float = 1e-4,
) -> torch.Tensor:
    """Flag segments that are (near-)constant: no window of ``window``
    samples inside the segment varies by more than ``threshold``.
    samples ``[B, S]`` -> bool ``[B]`` (True = dead)."""
    B, S = samples.shape
    n = S // window
    x = samples[:, : n * window].reshape(B, n, window)
    v = torch.var(x, dim=-1, unbiased=False)  # [B, n]
    t = torch.arange(n, device=samples.device) * window
    valid = t[None, :] + window <= lengths.to(samples.device)[:, None]
    live = (v > threshold) & valid
    return ~torch.any(live, dim=1)


def cross_correlation(a: torch.Tensor, b: torch.Tensor, max_lag: int) -> torch.Tensor:
    """Cross-correlation of equal-length signals for lags
    [-max_lag, max_lag]: a, b ``[..., S]`` -> ``[..., 2 * max_lag + 1]``."""
    n = _fft_size(a.shape[-1])
    fa = torch.fft.rfft(a, n=n, dim=-1)
    fb = torch.fft.rfft(b, n=n, dim=-1)
    cc = torch.fft.irfft(fa * torch.conj(fb), n=n, dim=-1)
    # lag k (a leads by k): cc[k]; negative lags wrap at the end
    return torch.cat([cc[..., -max_lag:], cc[..., : max_lag + 1]], dim=-1)
