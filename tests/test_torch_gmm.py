"""PyTorch port vs JAX: GMM mixture sets, scoring tensors and scorers.

Scores compare at 1e-5 (rtol and atol), the reference's own
Pallas-vs-jnp GMM tolerance: fp32 sums in another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rasr_tpu.ops.pallas.gmm_kernel as jax_gmm_kernel
from rasr_tpu.models import gmm as jgmm
from rasr_tpu.models import scorer as jscorer
from rasr_tpu_torch import convert
from rasr_tpu_torch.models import gmm as tgmm
from rasr_tpu_torch.models import scorer as tscorer
from rasr_tpu_torch.ops.kernels.gmm import gmm_scores

TOL = dict(rtol=1e-5, atol=1e-5)


def _mixtures(rng, M, K, D, ragged=True):
    ms = tgmm.MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 1.0 / K, np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    if ragged:  # the reference kernel test's ragged case: one 1-density mixture
        ms.num_densities[3] = 1
        ms.weights[3] = np.eye(1, K, dtype=np.float32)[0]
    return ms


def _jax_mixtures(ms):
    return jgmm.MixtureSet(ms.means, ms.variances, ms.weights, ms.num_densities)


@pytest.mark.parametrize("max_approx", [True, False])
def test_mixture_scores_match_jax_and_pallas(rng, max_approx):
    ms = _mixtures(rng, M=13, K=3, D=9)
    jst = jgmm.make_scoring_tensors(_jax_mixtures(ms))
    st = tgmm.make_scoring_tensors(ms, device="cpu")
    x = rng.normal(size=(2, 5, 9)).astype(np.float32)
    got = tgmm.mixture_scores(torch.from_numpy(x), st, max_approx).numpy()
    want = np.asarray(jgmm.mixture_scores(jnp.asarray(x), jst, max_approx))
    fused = np.asarray(
        jax_gmm_kernel.mixture_scores_fused(jnp.asarray(x), jst, max_approx, interpret=True)
    )
    assert got.shape == (2, 5, 13)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, fused, **TOL)
    # the kernel wrapper on a CPU tensor is the plain version
    before = gmm_scores.launches
    np.testing.assert_array_equal(gmm_scores(torch.from_numpy(x), st, max_approx).numpy(), got)
    assert gmm_scores.launches == before


def test_scoring_tensors_match_jax_and_convert(rng):
    ms = _mixtures(rng, M=6, K=4, D=5)
    jst = jgmm.make_scoring_tensors(_jax_mixtures(ms), var_floor=0.6)
    st = tgmm.make_scoring_tensors(ms, var_floor=0.6, device="cpu")
    carried = convert.scoring_tensors_from_jax(jst, device="cpu")
    for t in (st, carried):
        for name in ("a", "b", "c"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(jst, name)))
        assert (t.num_mixtures, t.max_densities, t.dim) == (6, 4, 5)
        # the kernel's operand: [a; b] per density k, K-major (the depth
        # contiguous, padded to 32), split into TF32 hi and lo planes
        op = t.operand.numpy()
        assert op.shape == (2, 4, 6, 32)  # hi|lo, k, mixture, depth
        assert not (op.view(np.int32) & 0x1FFF).any()  # every plane is TF32
        full = op[0].astype(np.float64) + op[1]  # hi + lo: k, mixture, depth
        ab = np.concatenate([np.asarray(jst.a), np.asarray(jst.b)]).reshape(10, 6, 4)
        np.testing.assert_allclose(full[:, :, :10], ab.transpose(2, 1, 0), rtol=2.0**-21, atol=0)
        assert not full[:, :, 10:].any()
        np.testing.assert_array_equal(
            t.c_k.numpy(), np.asarray(jst.c).reshape(6, 4).T
        )
    assert (st.c.numpy().reshape(6, 4)[3, 1:] == np.float32(tgmm.PAD_SCORE)).all()


def test_mixture_set_io_interchanges_with_jax(rng, tmp_path):
    ms = _mixtures(rng, M=4, K=2, D=3)
    _jax_mixtures(ms).save(str(tmp_path / "ref"))
    back = tgmm.MixtureSet.load(str(tmp_path / "ref"))
    ms.save(str(tmp_path / "port.npz"))
    ref_back = jgmm.MixtureSet.load(str(tmp_path / "port.npz"))
    for name in ("means", "variances", "weights", "num_densities"):
        np.testing.assert_array_equal(getattr(back, name), getattr(ms, name))
        np.testing.assert_array_equal(getattr(ref_back, name), getattr(ms, name))
    padded = ms.pad_to(5)
    assert padded.max_densities == 5 and padded.total_densities == ms.total_densities
    single = tgmm.MixtureSet.single_density(ms.means[:, 0], ms.variances[:, 0])
    assert single.max_densities == 1 and single.num_mixtures == 4


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gmm_scorer_matches_jax(rng, monkeypatch, use_pallas):
    if use_pallas:
        monkeypatch.setattr(
            jax_gmm_kernel, "mixture_scores_fused",
            functools.partial(jax_gmm_kernel.mixture_scores_fused, interpret=True),
        )
    ms = _mixtures(rng, M=11, K=3, D=7)
    x = rng.normal(size=(3, 6, 7)).astype(np.float32)
    want = jscorer.GmmFeatureScorer(_jax_mixtures(ms), scale=2.0, use_pallas=use_pallas)(x)
    scorer = tscorer.create_scorer("batch-diagonal-maximum", ms, scale=2.0, device="cpu")
    np.testing.assert_allclose(scorer(torch.from_numpy(x)).numpy(), np.asarray(want), **TOL)
    assert scorer.num_classes == 11


def test_precomputed_scorer_and_registry(rng):
    scores = rng.normal(size=(2, 4, 3)).astype(np.float32)
    sc = tscorer.create_scorer("precomputed", scores, scale=0.5, device="cpu")
    np.testing.assert_allclose(sc(torch.zeros(2, 4, 1), lengths=None).numpy(), 0.5 * scores)
    with pytest.raises(KeyError):
        tscorer.create_scorer("no-such-scorer")
