"""PyTorch port vs JAX: the feature frontend (MFCC / CMVN / splice / LDA).

The same numpy inputs go through ``rasr_tpu``'s frontend (plain jnp, and
the fused Pallas kernel in interpret mode) and the port's. Tolerance
2e-4 (rtol and atol), the reference's own Pallas-vs-jnp MFCC tolerance:
fp32 sums in another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rasr_tpu.ops.pallas.frontend_kernel as jax_frontend_kernel
from rasr_tpu.ops import frontend as jfe
from rasr_tpu_torch import convert
from rasr_tpu_torch.ops import frontend as tfe
from rasr_tpu_torch.ops.kernels.mfcc import folded_bases, mfcc_frames, mfcc_frames_plain

TOL = dict(rtol=2e-4, atol=2e-4)


def _audio(rng, lengths):
    x = (rng.normal(size=(len(lengths), max(lengths))) * 0.1).astype(np.float32)
    for b, n in enumerate(lengths):
        x[b, n:] = 0.0
    return x, np.asarray(lengths, np.int64)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_frontend_matches_jax(rng, monkeypatch, use_pallas):
    """FrontendConfig(), splice 4, a random LDA, ragged lengths."""
    if use_pallas:
        # the reference runs its Pallas kernel on the CPU in interpret mode
        monkeypatch.setattr(
            jax_frontend_kernel, "mfcc_frames_fused",
            functools.partial(jax_frontend_kernel.mfcc_frames_fused, interpret=True),
        )
    lda = (rng.normal(size=(16 * 9, 45)) * 0.1).astype(np.float32)
    x, lengths = _audio(rng, [16000, 11111, 7000, 300])
    want, want_n = jfe.FeatureFrontend(
        jfe.FrontendConfig(), splice_context=4, lda=lda, use_pallas=use_pallas
    )(x, lengths)
    got, got_n = tfe.FeatureFrontend(tfe.FrontendConfig(), splice_context=4, lda=lda)(
        torch.from_numpy(x), torch.from_numpy(lengths)
    )
    assert got.shape == want.shape == (4, 98, 45)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("normalize,splice", [("none", 0), ("segment", 2)])
def test_frontend_cepstra_without_lda_match_jax(rng, normalize, splice):
    cfg = dict(normalize=normalize, cep_lifter=22.0, window="hanning")
    x, lengths = _audio(rng, [8000, 5000])
    want, _ = jfe.FeatureFrontend(jfe.FrontendConfig(**cfg), splice_context=splice)(x, lengths)
    got, _ = tfe.FeatureFrontend(tfe.FrontendConfig(**cfg), splice_context=splice)(
        torch.from_numpy(x), torch.from_numpy(lengths)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_match_jax_and_convert():
    """The numpy basis maths is the reference's, bit for bit, and the
    converter carries the JAX params across unchanged."""
    cfg = jfe.FrontendConfig(cep_lifter=22.0)
    want = jfe.make_params(cfg)
    got = tfe.make_params(tfe.FrontendConfig(cep_lifter=22.0))
    carried = convert.frontend_params_from_jax(want)
    for name in ("window", "dft_cos", "dft_sin", "mel", "dct"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(
            getattr(carried, name).numpy(), np.asarray(getattr(want, name))
        )


def test_mfcc_wrapper_on_cpu_matches_pallas_kernel(rng):
    """The fused kernel's plain twin (what the wrapper runs on a CPU
    tensor) against the reference's Pallas kernel, on a frame count that
    is no multiple of any tile."""
    cfg = jfe.FrontendConfig()
    jparams = jfe.make_params(cfg)
    frames = rng.normal(size=(2, 37, cfg.frame_length)).astype(np.float32)
    want = jax_frontend_kernel.mfcc_frames_fused(
        jnp.asarray(frames), jparams, cfg, tile_n=8, interpret=True
    )
    p = tfe.make_params(tfe.FrontendConfig())
    cosw, sinw = folded_bases(p)
    before = mfcc_frames.launches
    got = mfcc_frames(torch.from_numpy(frames), cosw, sinw, p.mel, p.dct, cfg.log_floor)
    assert mfcc_frames.launches == before  # the CPU path launches no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    flat = mfcc_frames_plain(
        torch.from_numpy(frames.reshape(-1, cfg.frame_length)), cosw, sinw, p.mel, p.dct,
        cfg.log_floor,
    )
    np.testing.assert_allclose(flat.numpy().reshape(got.shape), got.numpy(), rtol=1e-6, atol=1e-6)


def test_framing_and_preemphasis_match_jax(rng):
    cfg = jfe.FrontendConfig()
    x = rng.normal(size=(2, 4000)).astype(np.float32)
    want = jfe.frame_signal(jfe.preemphasize(jnp.asarray(x), 0.97), 30, cfg)
    got = tfe.frame_signal(tfe.preemphasize(torch.from_numpy(x), 0.97), 30, tfe.FrontendConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tfe.FeatureFrontend(tfe.FrontendConfig(normalize="sliding"))
    with pytest.raises(NotImplementedError):
        tfe.FeatureFrontend(tfe.FrontendConfig(append_energy=True))
    with pytest.raises(NotImplementedError):
        tfe.FeatureFrontend(delta_order=2)
    with pytest.raises(NotImplementedError):
        tfe.FeatureFrontend(vtln_warp=np.eye(257, dtype=np.float32))
    with pytest.raises(NotImplementedError):
        tfe.deltas(torch.zeros(1, 3, 2))
