"""PyTorch port vs JAX: GMM EM, LDA, fMLLR and MLLR (``train/``).

The same seeded numpy frames, labels and weights go through both
packages on the CPU. Tolerances: EM, LDA, fMLLR and MLLR statistics 1e-5
relative (plus 1e-5 of the statistic's largest magnitude, for entries that
cancel towards 0: the port sums with ``index_add_`` in another order than
``segment_sum``); the models estimated from them 1e-5; LDA projections
1e-4, column by column up to sign (scatter matrices that differ in the
last bits may flip an eigenvector); fMLLR and MLLR transforms W 1e-4. The
reference's oracles (``tests/test_train.py``, ``tests/test_gmm.py``,
``tests/test_fmllr.py``) run on the port's side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rasr_tpu.models import gmm as jgmm
from rasr_tpu.train import em as jem
from rasr_tpu.train import fmllr as jfm
from rasr_tpu.train import lda as jlda
from rasr_tpu.train import mllr as jmllr
from rasr_tpu_torch import convert
from rasr_tpu_torch.models import gmm as tgmm
from rasr_tpu_torch.train import em as tem
from rasr_tpu_torch.train import fmllr as tfm
from rasr_tpu_torch.train import lda as tlda
from rasr_tpu_torch.train import mllr as tmllr
from tests.test_fmllr import _sample, _toy_model

STAT_RTOL, MODEL_TOL, PROJ_ATOL, W_ATOL = 1e-5, 1e-5, 1e-4, 1e-4


def assert_stats_close(got, want, rtol=STAT_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _mixtures(rng, M=7, K=3, D=5):
    ms = tgmm.MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 1.0 / K, np.float32),
        num_densities=np.full(M, K, np.int32))
    ms.num_densities[2] = 1  # a ragged mixture: padding densities
    ms.weights[2] = [1.0, 0.0, 0.0]
    return ms


def _jax_ms(ms):
    return jgmm.MixtureSet(ms.means, ms.variances, ms.weights, ms.num_densities)


def _frames(rng, M, B=3, T=40, D=5, weighted=True):
    feats = rng.normal(size=(B, T, D)).astype(np.float32) * 2
    labels = rng.integers(0, M, size=(B, T)).astype(np.int32)
    labels[1, 30:] = -1  # padding
    weights = rng.uniform(0.2, 1.0, size=(B, T)).astype(np.float32) if weighted else None
    return feats, labels, weights


def test_mixture_posteriors_match_jax(rng):
    ms = _mixtures(rng)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    jg, jt = jgmm.mixture_posteriors(jnp.asarray(x), jgmm.make_scoring_tensors(_jax_ms(ms)))
    tg, tt = tgmm.mixture_posteriors(torch.from_numpy(x), tgmm.make_scoring_tensors(ms, device="cpu"))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy().sum(-1), 1.0, rtol=1e-5)
    assert np.all(tg.numpy()[:, ~ms.density_mask] < 1e-12)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tying", ["density", "mixture", "pooled"])
def test_em_step_matches_jax(rng, weighted, tying):
    ms = _mixtures(rng)
    feats, labels, weights = _frames(rng, ms.num_mixtures, weighted=weighted)
    ja = jem.accumulate(jem.GmmAccumulator.zeros(7, 3, 5), _jax_ms(ms), feats, labels, weights)
    ta = tem.accumulate(tem.GmmAccumulator.zeros(7, 3, 5), ms, feats, labels, weights,
                        device="cpu")
    for f in ("count", "sum", "sumsq"):
        assert getattr(ta, f).dtype == np.float64
        assert_stats_close(getattr(ta, f), getattr(ja, f))
    want = jem.estimate(ja, prev=_jax_ms(ms), variance_tying=tying, min_observations=2.0)
    got = tem.estimate(ta, prev=ms, variance_tying=tying, min_observations=2.0)
    np.testing.assert_array_equal(got.num_densities, want.num_densities)
    for f in ("means", "variances", "weights"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
    # then a split with the same statistics
    js, ts = jem.split(want, ja), tem.split(got, ta)
    np.testing.assert_array_equal(ts.num_densities, js.num_densities)
    np.testing.assert_allclose(ts.means, js.means, rtol=MODEL_TOL, atol=MODEL_TOL)


def test_accumulator_files_are_the_reference_format(tmp_path, rng):
    ms = _mixtures(rng)
    feats, labels, weights = _frames(rng, ms.num_mixtures)
    ta = tem.accumulate(tem.GmmAccumulator.zeros(7, 3, 5), ms, torch.from_numpy(feats), labels,
                        weights)
    ta.save(str(tmp_path / "port"))
    back = jem.GmmAccumulator.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.sum, ta.sum)
    jem.GmmAccumulator(ta.count * 2, ta.sum, ta.sumsq).save(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(tem.GmmAccumulator.load(str(tmp_path / "jax")).count,
                                  ta.count * 2)
    sa = tlda.ScatterAccumulator.zeros(7, 5)
    tlda.accumulate_scatter(sa, torch.from_numpy(feats), labels).save(str(tmp_path / "sc"))
    np.testing.assert_array_equal(jlda.ScatterAccumulator.load(str(tmp_path / "sc")).total_sqsum,
                                  sa.total_sqsum)


@pytest.mark.parametrize("seed", [0, 1])
def test_lda_matches_jax(seed):
    rng = np.random.default_rng(seed)
    C, D = 6, 8
    feats = rng.normal(size=(2, 150, D)).astype(np.float32)
    labels = rng.integers(0, C, size=(2, 150)).astype(np.int32)
    feats += (np.arange(C)[:, None] * rng.normal(size=(C, D)) * 0.7).astype(np.float32)[labels]
    labels[0, 140:] = -1
    ja = jlda.accumulate_scatter(jlda.ScatterAccumulator.zeros(C, D), feats, labels)
    ta = tlda.accumulate_scatter(tlda.ScatterAccumulator.zeros(C, D), feats, labels,
                                 device="cpu")
    for f in ("class_count", "class_sum", "total_sqsum"):
        assert_stats_close(getattr(ta, f), getattr(ja, f))
    jp, jv = jlda.estimate_lda(ja, output_dim=4)
    tp, tv = tlda.estimate_lda(ta, output_dim=4)
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    signs = np.sign((tp * jp).sum(0))
    np.testing.assert_allclose(tp * signs, jp, atol=PROJ_ATOL)


def test_fmllr_matches_jax():
    rng = np.random.default_rng(0)
    ms = _toy_model(rng)
    x, mix = _sample(rng, ms, 1500)
    A0 = np.eye(ms.dim) + 0.15 * rng.normal(size=(ms.dim, ms.dim))
    xc = (x @ A0.T + 0.5 * rng.normal(size=ms.dim)).astype(np.float32)
    valid = rng.uniform(size=1500) < 0.9
    jG, jk, jb = jfm.fmllr_stats(xc, mix, ms, valid)
    tG, tk, tb = tfm.fmllr_stats(torch.from_numpy(xc), mix, convert.mixture_set_from_jax(ms),
                                 valid)
    assert_stats_close(tG, jG)
    assert_stats_close(tk, jk)
    assert tb == jb == float(valid.sum())
    W = tfm.estimate_fmllr(tG, tk, tb, iterations=10)
    np.testing.assert_allclose(W, jfm.estimate_fmllr(jG, jk, jb, iterations=10), atol=W_ATOL)
    # the model tensors on their own, as the reference takes them
    mt = tfm.FmllrModelTensors.from_mixture_set(ms, device="cpu")
    assert_stats_close(tfm.fmllr_stats(xc, mix, mt, valid, device="cpu")[0], jG)


def test_mllr_matches_jax():
    rng = np.random.default_rng(3)
    ms = _toy_model(rng, M=6, K=2, D=5)
    x, mix = _sample(rng, ms, 3000)
    bad = jgmm.MixtureSet((ms.means + 0.7).astype(np.float32), ms.variances, ms.weights,
                          ms.num_densities)
    jg, jgx = jmllr.mllr_stats(x, mix, bad)
    tg, tgx = tmllr.mllr_stats(x, mix, convert.mixture_set_from_jax(bad), device="cpu")
    assert_stats_close(tg, jg)
    assert_stats_close(tgx, jgx)
    classes = jmllr.default_regression_classes(bad, 2)
    np.testing.assert_array_equal(
        tmllr.default_regression_classes(convert.mixture_set_from_jax(bad), 2), classes)
    jW = jmllr.estimate_mllr(jg, jgx, bad, classes=classes, min_count=50.0)
    tW = tmllr.estimate_mllr(tg, tgx, convert.mixture_set_from_jax(bad), classes=classes,
                             min_count=50.0)
    assert sorted(tW) == sorted(jW)
    for c in jW:
        np.testing.assert_allclose(tW[c], jW[c], atol=W_ATOL)
    np.testing.assert_allclose(tmllr.adapt_means(convert.mixture_set_from_jax(bad), tW,
                                                 classes).means,
                               jmllr.adapt_means(bad, jW, classes).means, atol=1e-3)


def test_transform_batch_equals_the_host_transforms():
    """The recognizer's batched [B, D, D] product == the reference's host
    ``apply_speaker_transforms`` (float64 there: 1e-5)."""
    class Seg:
        def __init__(self, speaker):
            self.speaker = speaker

    rng = np.random.default_rng(4)
    D = 6
    table = {"a": np.hstack([np.eye(D) + 0.1 * rng.normal(size=(D, D)), rng.normal(size=(D, 1))]),
             "*": np.hstack([2.0 * np.eye(D), np.ones((D, 1))])}
    feats = rng.normal(size=(3, 9, D)).astype(np.float32)
    segs = [Seg("a"), Seg(None), Seg("b")]
    want = jfm.apply_speaker_transforms(feats, segs, table)
    np.testing.assert_allclose(tfm.transform_batch(torch.from_numpy(feats), segs, table).numpy(),
                               want, atol=1e-5)
    np.testing.assert_array_equal(tfm.apply_speaker_transforms(feats, segs, table), want)
    A, b = tfm.batch_transform_tensors(segs[1:], {"a": table["a"]}, D)
    np.testing.assert_array_equal(A, np.tile(np.eye(D, dtype=np.float32), (2, 1, 1)))


# ---------------------------------------- the reference's oracles, on the port
def test_em_single_gaussian_recovers_moments(rng):
    D = 4
    data = rng.normal(loc=2.0, scale=1.5, size=(500, D)).astype(np.float32)
    model = tgmm.MixtureSet.single_density(np.zeros((1, D), np.float32),
                                           np.ones((1, D), np.float32))
    acc = tem.accumulate(tem.GmmAccumulator.zeros(1, 1, D), model, data,
                         np.zeros(500, np.int32), device="cpu")
    new = tem.estimate(acc, variance_floor_factor=0.0)
    np.testing.assert_allclose(new.means[0, 0], data.mean(0), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(new.variances[0, 0], data.var(0), rtol=1e-3, atol=1e-3)


def test_em_two_density_separation(rng):
    data = np.concatenate([rng.normal(loc=-3.0, size=(300, 2)),
                           rng.normal(loc=3.0, size=(300, 2))]).astype(np.float32)
    labels = np.zeros(600, np.int32)
    model = tgmm.MixtureSet.single_density(data.mean(0, keepdims=True),
                                           data.var(0, keepdims=True))
    for _ in range(2):
        model = tem.split(model)
        for _ in range(5):
            acc = tem.accumulate(tem.GmmAccumulator.zeros(*model.means.shape), model, data,
                                 labels, device="cpu")
            model = tem.estimate(acc, prev=model)
    centers = sorted(model.means[0, : model.num_densities[0], 0].tolist())
    assert model.num_densities[0] >= 2
    assert abs(centers[0] + 3) < 0.5 and abs(centers[-1] - 3) < 0.5
    np.testing.assert_allclose(model.weights[0, : model.num_densities[0]].sum(), 1.0, rtol=1e-5)


def test_em_padding_labels_and_merge(rng):
    D, M = 3, 4
    feats = rng.normal(size=(2, 50, D)).astype(np.float32)
    labels = rng.integers(0, M, size=(2, 50)).astype(np.int32)
    labels[1, 40:] = -1
    model = tgmm.MixtureSet.single_density(np.zeros((M, D), np.float32),
                                           np.ones((M, D), np.float32))
    acc = tem.accumulate(tem.GmmAccumulator.zeros(M, 1, D), model, feats, labels, device="cpu")
    np.testing.assert_allclose(acc.count.sum(), 90.0, rtol=1e-5)
    np.testing.assert_allclose(acc.count[:, 0], np.bincount(labels[labels >= 0], minlength=M),
                               rtol=1e-5)
    a = tem.accumulate(tem.GmmAccumulator.zeros(M, 1, D), model, feats[0], labels[0],
                       device="cpu")
    b = tem.accumulate(tem.GmmAccumulator.zeros(M, 1, D), model, feats[1], labels[1],
                       device="cpu")
    a.merge(b)
    np.testing.assert_allclose(a.count, acc.count, rtol=1e-5)
    np.testing.assert_allclose(a.sum, acc.sum, rtol=1e-4, atol=1e-4)


def test_min_observation_pruning(rng):
    model = tgmm.MixtureSet(means=rng.normal(size=(1, 2, 2)).astype(np.float32),
                            variances=np.ones((1, 2, 2), np.float32),
                            weights=np.array([[0.5, 0.5]], np.float32),
                            num_densities=np.array([2], np.int32))
    acc = tem.GmmAccumulator.zeros(1, 2, 2)
    acc.count[0] = [100.0, 0.5]
    acc.sum[0, 0] = 100.0 * np.array([1.0, 2.0])
    acc.sumsq[0, 0] = 100.0 * (np.array([1.0, 2.0]) ** 2 + 1.0)
    new = tem.estimate(acc, min_observations=1.0, prev=model)
    assert new.num_densities[0] == 1
    np.testing.assert_allclose(new.means[0, 0], [1.0, 2.0], rtol=1e-6)
    with pytest.raises(ValueError, match="variance_tying"):
        tem.estimate(acc, variance_tying="full")


def test_lda_separates_informative_dim(rng):
    feats = rng.normal(size=(400, 4)).astype(np.float32)
    labels = (rng.uniform(size=400) < 0.5).astype(np.int32)
    feats[:, 0] += labels * 5.0
    feats[:, 2] *= 4.0
    acc = tlda.accumulate_scatter(tlda.ScatterAccumulator.zeros(2, 4), feats, labels,
                                  device="cpu")
    lda, vals = tlda.estimate_lda(acc, output_dim=2)
    assert lda.shape == (4, 2)
    assert (np.abs(lda[:, 0]) / np.linalg.norm(lda[:, 0]))[0] > 0.9
    assert vals[0] > 5 * max(vals[1], 1e-9)
    proj = feats @ lda[:, :1]
    v = np.concatenate([proj[labels == c] - proj[labels == c].mean(0) for c in (0, 1)])
    np.testing.assert_allclose(v.var(), 1.0, rtol=0.15)


def test_fmllr_recovers_affine_corruption():
    rng = np.random.default_rng(0)
    ms = convert.mixture_set_from_jax(_toy_model(rng))
    D = ms.dim
    x, mix = _sample(rng, ms, 4000)
    A0 = np.eye(D) + 0.15 * rng.normal(size=(D, D))
    c0 = 0.5 * rng.normal(size=D)
    xc = (x @ A0.T + c0).astype(np.float32)
    G, k, beta = tfm.fmllr_stats(xc, mix, ms, device="cpu")
    W = tfm.estimate_fmllr(G, k, beta, iterations=30)
    A, b = W[:, :-1], W[:, -1]
    assert np.abs(A @ A0 - np.eye(D)).max() < 0.08
    assert np.abs(A @ c0 + b).max() < 0.2
    assert np.abs(tfm.apply_fmllr(xc, W) - x).mean() < 0.15
    ident = np.hstack([np.eye(D), np.zeros((D, 1))])
    q_prev = tfm.fmllr_auxiliary(G, k, beta, ident)
    for it in (1, 3, 30):
        q = tfm.fmllr_auxiliary(G, k, beta, tfm.estimate_fmllr(G, k, beta, iterations=it))
        assert q >= q_prev - 1e-6
        q_prev = q


def test_fmllr_stats_additive_min_count_and_io(tmp_path):
    rng = np.random.default_rng(1)
    ms = convert.mixture_set_from_jax(_toy_model(rng))
    x, mix = _sample(rng, ms, 400)
    G, k, beta = tfm.fmllr_stats(x, mix, ms, device="cpu")
    G1, k1, b1 = tfm.fmllr_stats(x[:150], mix[:150], ms, device="cpu")
    G2, k2, b2 = tfm.fmllr_stats(x[150:], mix[150:], ms, device="cpu")
    np.testing.assert_allclose(G, G1 + G2, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(k, k1 + k2, rtol=1e-4, atol=1e-3)
    assert beta == b1 + b2 == 400.0
    W = tfm.estimate_fmllr(G, k, beta, min_count=1000.0)
    np.testing.assert_array_equal(W, np.hstack([np.eye(ms.dim), np.zeros((ms.dim, 1))]))
    path = str(tmp_path / "fmllr.json")
    tfm.save_transforms(path, {"alice": W})
    np.testing.assert_allclose(jfm.load_transforms(path)["alice"], W)
    np.testing.assert_allclose(tfm.load_transforms(path)["alice"], W)


def test_mllr_recovers_mean_corruption_per_class():
    rng = np.random.default_rng(4)
    ms = convert.mixture_set_from_jax(_toy_model(rng, M=6, K=2, D=4))
    x, mix = _sample(rng, ms, 6000)
    classes = np.array([0, 0, 0, 1, 1, 1])
    bad_means = ms.means.copy()
    for c, sh in {0: 1.5, 1: -2.0}.items():
        bad_means[classes == c] += sh
    bad = tgmm.MixtureSet(bad_means.astype(np.float32), ms.variances, ms.weights,
                          ms.num_densities)
    g, gx = tmllr.mllr_stats(x, mix, bad, device="cpu")
    W2 = tmllr.estimate_mllr(g, gx, bad, classes=classes, min_count=50.0)
    W1 = tmllr.estimate_mllr(g, gx, bad, min_count=50.0)
    err2 = np.abs(tmllr.adapt_means(bad, W2, classes).means - ms.means).mean()
    err1 = np.abs(tmllr.adapt_means(bad, W1).means - ms.means).mean()
    assert err2 < err1 and err2 < 0.3
    Wb = tmllr.estimate_mllr(g, gx, bad, classes=classes, min_count=1e7)
    np.testing.assert_array_equal(Wb[0], Wb[1])
