"""PyTorch port vs JAX: the miscellaneous DSP ops (``ops/dsp.py``).

Every case of ``tests/test_dsp.py``: the same seeded numpy inputs go
through ``rasr_tpu.ops.dsp`` and ``rasr_tpu_torch.ops.dsp`` on the CPU,
and the port is held to the JAX function and to the case's own oracle.
Tolerances: 1e-5 relative for float32 elementwise chains and sums taken
in another order; the FFT paths (pocketfft in both, other plans) 1e-4
relative with an absolute floor of 1e-4 x the signal energy; selections
(argmax, masks, flags) exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rasr_tpu.ops import dsp as jdsp
from rasr_tpu_torch.ops import dsp as tdsp


def _both(name, *args, **kw):
    """(JAX result, port result) of ``name`` on the same numpy inputs."""
    want = getattr(jdsp, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                  for a in args), **kw)
    got = getattr(tdsp, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                for a in args), **kw)
    return want, got


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_autocorrelation_matches_numpy_and_jax(rng):
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    want, got = _both("autocorrelation", x, max_lag=8)
    _close(got, want, rtol=1e-4, atol=1e-4 * float((x * x).sum(-1).max()))
    r = got.numpy()
    for b in range(2):
        for t in range(3):
            full = np.correlate(x[b, t], x[b, t], mode="full")
            np.testing.assert_allclose(r[b, t], full[63:72], rtol=1e-4, atol=1e-3)


def test_levinson_matches_direct_solve_and_jax(rng):
    a_true = np.array([0.6, -0.3, 0.1])
    x = np.zeros(4000, np.float64)
    e = rng.normal(size=4000) * 0.1
    for t in range(3, 4000):
        x[t] = a_true @ x[t - 3 : t][::-1] + e[t]
    r = (np.array([np.dot(x[: 4000 - k], x[k:]) for k in range(4)]) / 4000)[None]
    r = r.astype(np.float32)
    want, got = _both("levinson", r, order=3)
    for g, w in zip(got, want):
        _close(g, w)
    import scipy.linalg as sla

    a = got[0].numpy()[0]
    np.testing.assert_allclose(a, sla.solve_toeplitz((r[0, :3], r[0, :3]), r[0, 1:4]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(a, a_true, atol=0.1)
    assert float(got[2][0]) > 0


def test_zero_crossing_rate_oracle_and_jax(rng):
    x = rng.normal(size=(2, 5, 40)).astype(np.float32)
    want, got = _both("zero_crossing_rate", x)
    _close(got, want, rtol=0, atol=1e-7)
    s = np.sign(x)
    np.testing.assert_allclose(got.numpy(), np.mean(np.abs(s[..., 1:] - s[..., :-1]) > 1.0, -1),
                               atol=1e-6)


def test_spectral_moments_on_tone_and_noise(rng):
    sr, n = 16000, 512
    t = np.arange(n) / sr
    tone = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    spec = np.stack([np.abs(np.fft.rfft(tone)) ** 2,
                     np.abs(np.fft.rfft(rng.normal(size=n))) ** 2]).astype(np.float32)
    want, got = _both("spectral_moments", spec[None], sr)
    _close(got, want, rtol=1e-5, atol=1e-2)  # Hz
    m = got.numpy()
    assert abs(m[0, 0, 0] - 1000.0) < 40.0 and m[0, 0, 1] < 120.0


def test_harmonic_sum_pitch_detects_f0():
    sr, n = 16000, 1024
    t = np.arange(n) / sr
    x = sum((0.6 / h) * np.sin(2 * np.pi * 120.0 * h * t) for h in range(1, 6))
    spec = np.abs(np.fft.rfft(x, n)) ** 2
    noise = np.abs(np.fft.rfft(np.random.default_rng(0).normal(size=n), n)) ** 2
    power = np.stack([spec, noise])[None].astype(np.float32)
    want, got = _both("harmonic_sum_pitch", power, sr, fft_size=n)
    _close(got, want)
    out = got.numpy()
    assert abs(out[0, 0, 0] - 120.0) <= 1.5 * sr / n + 1.0
    assert out[0, 0, 1] > out[0, 1, 1]


def test_histogram_normalization_gaussianizes(rng):
    B, T, D = 2, 400, 3
    feats = (rng.exponential(size=(B, T, D)) ** 1.5).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 300:] = 0.0
    want, got = _both("histogram_normalization", feats, mask)
    _close(got, want)
    out = got.numpy()
    assert abs(out[0].mean()) < 0.15 and abs(out[0].std() - 1.0) < 0.25
    idx = np.argsort(feats[0, :, 0])
    assert np.all(np.diff(out[0, idx, 0]) > -1e-4)
    assert np.all(out[1, 300:] == 0.0)


def test_noise_estimate_and_spectral_subtraction(rng):
    sr, n, T = 16000, 256, 50
    tone = np.sin(2 * np.pi * 800.0 * np.arange(n) / sr)
    frames = rng.normal(size=(1, T, n)) * 0.1
    frames[0, 10:40] += tone[None, :]
    spec = (np.abs(np.fft.rfft(frames, axis=-1)) ** 2).astype(np.float32)
    mask = np.ones((1, T), np.float32)
    mask[0, 45:] = 0.0  # padded frames never count as noise
    want, noise = _both("noise_estimate", spec, mask)
    _close(noise, want)
    bin800 = round(800 * n / sr)
    assert noise[0, bin800] < spec[0, 20, bin800] * 0.05
    want, clean = _both("spectral_subtraction", spec, noise.numpy())
    _close(clean, want)
    assert clean[0, 2].sum() < spec[0, 2].sum() * 0.6
    assert clean[0, 20, bin800] > spec[0, 20, bin800] * 0.8


def test_dc_detection():
    sr = 16000
    live = np.sin(2 * np.pi * 440 * np.arange(sr) / sr).astype(np.float32)
    x = np.stack([live, np.full(sr, 0.3, np.float32), live])
    lengths = np.array([sr, sr, 100])  # the third: too short for any window
    want, got = _both("dc_detection", x, lengths)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [False, True, True]


def test_cross_correlation_matches_numpy(rng):
    a = rng.normal(size=(2, 50)).astype(np.float32)
    b = rng.normal(size=(2, 50)).astype(np.float32)
    want, got = _both("cross_correlation", a, b, 5)
    _close(got, want, rtol=1e-4, atol=1e-4)
    for i in range(2):
        for k in range(-5, 6):
            ref = np.dot(a[i, k:], b[i, : 50 - k]) if k >= 0 else np.dot(a[i, : 50 + k], b[i, -k:])
            np.testing.assert_allclose(got[i, 5 + k].item(), ref, rtol=1e-3, atol=1e-3)


def test_normalize_energy():
    e = np.array([[1.0, 5.0, 3.0, 0.0]], np.float32)
    m = np.array([[1, 1, 1, 0]], np.float32)
    want, got = _both("normalize_energy", e, m)
    _close(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy()[0], [-4.0, 0.0, -2.0, 0.0], atol=1e-6)


@pytest.mark.parametrize("hangover", [0, 5])
def test_frame_energy_and_silence_detection(rng, hangover):
    """The energy node and the silence detector (no case of their own in
    tests/test_dsp.py): speech frames in noise, ragged masks."""
    frames = (rng.normal(size=(2, 60, 40)) * 0.01).astype(np.float32)
    frames[:, 20:30] *= 100.0
    mask = np.ones((2, 60), np.float32)
    mask[1, 50:] = 0.0
    for log in (False, True):  # the detector reads the log energy
        want, energy = _both("frame_energy", frames, log=log)
        _close(energy, want)
    want, speech = _both("silence_detection", energy.numpy(), mask, hangover=hangover)
    np.testing.assert_array_equal(speech.numpy(), np.asarray(want))
    assert speech[:, 20:30].all() and not speech[:, :20 - hangover].any()


@pytest.mark.parametrize("shift", [3, -4, 0])
def test_fir_filter_and_delay(rng, shift):
    """The linear-filter and delay nodes (no case of their own in
    tests/test_dsp.py), against JAX and a direct convolution."""
    x = rng.normal(size=(2, 3, 70)).astype(np.float32)
    taps = rng.normal(size=7).astype(np.float32)
    want, got = _both("fir_filter", x, taps)
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), np.apply_along_axis(
        lambda r: np.convolve(r, taps)[:70], -1, x), rtol=1e-5, atol=1e-5)
    want, got = _both("delay", x, shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
