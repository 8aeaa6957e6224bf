"""PyTorch port vs JAX: the feature frontend (MFCC / CMVN / splice / LDA,
and the energy column, sliding CMVN, deltas and VTLN).

The same numpy inputs go through ``rasr_tpu``'s frontend (plain jnp, and
the fused Pallas kernel in interpret mode) and the port's. Tolerance
2e-4 (rtol and atol), the reference's own Pallas-vs-jnp MFCC tolerance:
fp32 sums in another order.

Sliding CMVN keeps the reference's formula: the variance as E[x^2] -
mean^2 from differences of float32 cumulative sums. On a short row the
window holds a few frames whose log energy (~7) varies by ~0.03, so the
difference cancels ~5 digits (mean^2 / var ~ 1e4-1e5), and the two
packages' cumulative sums, rounded in another order, move the output by
up to 0.031 (a 3-frame row, 12 seeds tried; rows of 45-98 frames up to
0.007). Features normalized by a sliding window are therefore held to
5e-2 absolute (they have unit variance). ``sliding_cmvn`` alone is held
to 1e-4 on well-conditioned inputs, and on an ill-conditioned window to
the float64 value of the same formula no worse than the reference is.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rasr_tpu.ops.pallas.frontend_kernel as jax_frontend_kernel
from rasr_tpu.ops import frontend as jfe
from rasr_tpu.ops.gammatone import piecewise_linear_warp
from rasr_tpu_torch import convert
from rasr_tpu_torch.ops import frontend as tfe
from rasr_tpu_torch.ops.kernels.mfcc import (
    folded_bases, mfcc_frames, mfcc_frames_plain, pack_basis, pack_basis_shape, with_energy,
)

TOL = dict(rtol=2e-4, atol=2e-4)
SLIDING_TOL = dict(rtol=2e-4, atol=5e-2)


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
    got, got_n = tfe.FeatureFrontend(tfe.FrontendConfig(), splice_context=4, lda=lda, device="cpu")(
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
    got, _ = tfe.FeatureFrontend(tfe.FrontendConfig(**cfg), splice_context=splice, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(lengths)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_match_jax_and_convert():
    """The numpy basis maths is the reference's, bit for bit, and the
    converter carries the JAX params across unchanged."""
    cfg = jfe.FrontendConfig(cep_lifter=22.0)
    want = jfe.make_params(cfg)
    got = tfe.make_params(tfe.FrontendConfig(cep_lifter=22.0), device="cpu")
    carried = convert.frontend_params_from_jax(want, device="cpu")
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
    p = tfe.make_params(tfe.FrontendConfig(), device="cpu")
    cosw, sinw = folded_bases(p)
    before = mfcc_frames.launches
    got = mfcc_frames(torch.from_numpy(frames), cosw, sinw, p.mel, p.dct, cfg.log_floor,
                      pack_basis(cosw, sinw))
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
    """The four options that raised before the frontend remainder was
    ported (sliding CMVN, ``append_energy``, deltas, VTLN) now build, with
    the reference's output dimension, and ``deltas`` runs on a tensor."""
    for cfg, kw, dim in ((dict(normalize="sliding"), {}, 16),
                         (dict(append_energy=True), {}, 17),
                         ({}, dict(delta_order=2), 48),
                         ({}, dict(vtln_warp=np.eye(257, dtype=np.float32)), 16)):
        fe = tfe.FeatureFrontend(tfe.FrontendConfig(**cfg), device="cpu", **kw)
        assert fe.output_dim == jfe.FeatureFrontend(jfe.FrontendConfig(**cfg), **kw).output_dim
        assert fe.output_dim == dim
    assert tfe.deltas(torch.zeros(1, 3, 2)).shape == (1, 3, 6)


FOUR_OPTIONS = {
    "energy": (dict(append_energy=True), {}),
    "sliding": (dict(normalize="sliding", norm_window=30), {}),
    "deltas": ({}, dict(delta_order=2)),
    "vtln": ({}, dict(vtln_warp=0.92)),
    "all-four": (dict(append_energy=True, normalize="sliding", norm_window=30),
                 dict(delta_order=2, vtln_warp=1.08)),
    "all-four+splice+lda": (dict(append_energy=True, normalize="sliding"),
                            dict(delta_order=1, vtln_warp=0.88, splice_context=1)),
}


@pytest.mark.parametrize("name", sorted(FOUR_OPTIONS))
def test_frontend_options_match_jax(rng, name):
    """Each of the four options alone and all four together, on a ragged
    batch (a row of 3 frames, a row shorter than one frame), port == JAX."""
    cfg, kw = FOUR_OPTIONS[name]
    kw = dict(kw)
    if "vtln_warp" in kw:
        kw["vtln_warp"] = piecewise_linear_warp(257, kw["vtln_warp"])
    if "splice_context" in kw:
        kw["lda"] = (rng.normal(size=(17 * 2 * 3, 40)) * 0.1).astype(np.float32)
    x, lengths = _audio(rng, [16000, 11111, 7000, 720, 300])
    want, want_n = jfe.FeatureFrontend(jfe.FrontendConfig(**cfg), **kw)(x, lengths)
    fe = tfe.FeatureFrontend(tfe.FrontendConfig(**cfg), device="cpu", **kw)
    got, got_n = fe(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == np.asarray(want).shape == (5, 98, fe.output_dim)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    tol = SLIDING_TOL if cfg.get("normalize") == "sliding" else TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_sliding_cmvn_and_deltas_match_jax(rng):
    """The two functions alone on identical inputs: 1000 frames under the
    default 300-frame window, masked tails; deltas with per-row edge
    fills."""
    f = (rng.normal(size=(3, 1000, 17)) * 10.0 + 20.0).astype(np.float32)
    m = np.ones((3, 1000), np.float32)
    m[1, 500:] = 0.0
    m[2, 993:] = 0.0
    for var in (True, False):
        want = jfe.sliding_cmvn(jnp.asarray(f), jnp.asarray(m), 300, var)
        got = tfe.sliding_cmvn(torch.from_numpy(f), torch.from_numpy(m), 300, var)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # 3 frames of a log energy near 7 varying by 0.03: the port's float32
    # error against the formula in float64 is at most twice the reference's
    e = (7.0 + 0.03 * rng.normal(size=(4, 40, 1))).astype(np.float32)
    em = np.zeros((4, 40), np.float32)
    em[:, :3] = 1.0
    exact = tfe.sliding_cmvn(torch.from_numpy(e).double(), torch.from_numpy(em).double(),
                             300).numpy()
    got = tfe.sliding_cmvn(torch.from_numpy(e), torch.from_numpy(em), 300).numpy()
    want = np.asarray(jfe.sliding_cmvn(jnp.asarray(e), jnp.asarray(em), 300))
    assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max() + 1e-4
    n = np.array([1000, 500, 993])
    for order, window in ((1, 2), (2, 2), (2, 3)):
        want = jfe.deltas(jnp.asarray(f), order, window, n_frames=jnp.asarray(n))
        got = tfe.deltas(torch.from_numpy(f), order, window, n_frames=torch.from_numpy(n))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_energy_column_rides_the_kernel_operands(rng):
    """The energy column comes out of the fused kernel's own maths: the
    plain twin over ``with_energy``'s operands (what the kernel computes
    on the card) == the reference's ``mfcc_from_frames`` with
    ``append_energy`` under a warped mel (the energy on the unwarped
    power), and the CPU wrapper launches nothing."""
    cfg = jfe.FrontendConfig(append_energy=True)
    warp = piecewise_linear_warp(257, 0.92)
    jparams = jfe.FeatureFrontend(cfg, vtln_warp=warp).params
    frames = (rng.normal(size=(2, 37, cfg.frame_length)) * 0.1).astype(np.float32)
    frames[1, :10] *= 1e-3  # near-silent frames
    want = jfe.mfcc_from_frames(jnp.asarray(frames), jparams, cfg)
    fe = tfe.FeatureFrontend(tfe.FrontendConfig(append_energy=True), vtln_warp=warp,
                             device="cpu")
    kmel, kdct = with_energy(fe.mel, fe.dct)
    assert kmel.shape == (257, 21) and kdct.shape == (21, 17)
    before = mfcc_frames.launches
    got = mfcc_frames(torch.from_numpy(frames), fe.cosw, fe.sinw, kmel, kdct,
                      cfg.log_floor, fe.basis)
    assert mfcc_frames.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tfe.mfcc_from_frames(torch.from_numpy(frames), fe.params, fe.cfg).numpy(),
        np.asarray(want), **TOL)


@pytest.mark.parametrize("sample_rate", [16000, 8000])
def test_packed_basis_holds_the_folded_bases(sample_rate):
    """The MFCC kernel's operand: [cosw | sinw] K-major, the cos and sin
    columns of a bin side by side, split into TF32 hi + lo, depth padded
    to whole TMA rows of 32."""
    cfg = tfe.FrontendConfig(sample_rate=sample_rate)
    cosw, sinw = folded_bases(tfe.make_params(cfg, device="cpu"))
    L, bins = cosw.shape
    op = pack_basis(cosw, sinw)
    assert tuple(op.shape) == pack_basis_shape(L, bins)
    assert not (op.view(torch.int32) & 0x1FFF).any()  # every plane is TF32
    planes, cols, Lp = op.shape
    assert planes == 2 and cols == 2 * bins and Lp % 32 == 0 and Lp - 32 < L <= Lp
    full = (op[0].double() + op[1].double()).reshape(bins, 2, Lp)  # hi + lo: bin, cos|sin, l
    torch.testing.assert_close(full[:, 0, :L].T, cosw.double(), rtol=2.0**-21, atol=0)
    torch.testing.assert_close(full[:, 1, :L].T, sinw.double(), rtol=2.0**-21, atol=0)
    assert not full[:, :, L:].any()
