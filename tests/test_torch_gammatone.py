"""PyTorch port vs JAX: the gammatone frontend, the VTLN warp and the
per-speaker warping-factor estimation (``ops/gammatone.py``,
``train/vtln.py``).

The cases of ``tests/test_extras.py`` that cover these modules, each run
through both packages on the same seeded numpy inputs. Tolerances: the
filter and warp matrices are the same numpy code (bit-equal); gammatone
features 1e-4 relative (float32 convolutions summed in another order,
then the 10th root, which shrinks relative errors tenfold); the VTLN
estimate picks the same factor, with each factor's total alignment cost
within 1e-5 relative (float32 frontend and GMM sums in another order,
summed over ~200 frames).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rasr_tpu.ops import gammatone as jgt
from rasr_tpu_torch import convert
from rasr_tpu_torch.ops import gammatone as tgt

GT_TOL = dict(rtol=1e-4, atol=1e-6)


def test_gammatone_kernels_properties():
    kernels, centers = tgt.gammatone_kernels(16, 16000)
    want_k, want_c = jgt.gammatone_kernels(16, 16000)
    np.testing.assert_array_equal(kernels, want_k)
    np.testing.assert_array_equal(centers, want_c)
    np.testing.assert_allclose((kernels**2).sum(axis=1), 1.0, rtol=1e-5)
    assert np.all(np.diff(centers) > 0)
    assert centers[0] >= 99 and centers[-1] <= 8000 + 1e-6


def test_gammatone_frontend_discriminates_tones():
    """A 500 Hz and a 4 kHz tone excite different channels; port == JAX
    with a ragged second row."""
    cfg = dict(num_channels=16)
    sr = 16000
    t = np.arange(sr // 2) / sr
    low = (0.3 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    high = (0.3 * np.sin(2 * np.pi * 4000 * t)).astype(np.float32)
    x, lengths = np.stack([low, high]), np.array([len(low), len(high) - 2345])
    x[1, lengths[1]:] = 0.0
    want, want_n = jgt.GammatoneFrontend(jgt.GammatoneConfig(**cfg))(x, lengths)
    fe = tgt.GammatoneFrontend(tgt.GammatoneConfig(**cfg), device="cpu")
    feats, n = fe(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), **GT_TOL)
    n0 = int(n[0])
    assert n0 > 10
    assert np.argmax(feats[0, :n0].mean(0)) < np.argmax(feats[1, : int(n[1])].mean(0))


@pytest.mark.parametrize("num_samples", [8000, 8001, 399])
def test_gammatone_dct_output_dim(rng, num_samples):
    """The DCT outputs, at a length off the frame grid and one too short
    for a single frame."""
    x = rng.normal(size=(2, num_samples)).astype(np.float32)
    lengths = np.array([num_samples, num_samples // 2])
    want, want_n = jgt.GammatoneFrontend(jgt.GammatoneConfig(num_channels=16, num_outputs=8))(
        x, lengths)
    fe = tgt.GammatoneFrontend(tgt.GammatoneConfig(num_channels=16, num_outputs=8), device="cpu")
    feats, n = fe(torch.from_numpy(x), torch.from_numpy(lengths))
    assert feats.shape[-1] == 8 and fe.output_dim == 8
    assert feats.shape == np.asarray(want).shape
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("alpha", [1.0, 0.92, 1.12])
def test_vtln_warp_matches_jax(alpha):
    np.testing.assert_array_equal(tgt.piecewise_linear_warp(257, alpha),
                                  jgt.piecewise_linear_warp(257, alpha))


def test_vtln_identity():
    warp = tgt.piecewise_linear_warp(64, alpha=1.0)
    spec = np.random.default_rng(0).uniform(size=(3, 64)).astype(np.float32)
    out = tgt.apply_vtln(torch.from_numpy(spec), torch.from_numpy(warp)).numpy()
    np.testing.assert_allclose(out, spec, atol=1e-5)
    want = jgt.apply_vtln(jnp.asarray(spec), jnp.asarray(warp))
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_vtln_compresses_or_stretches():
    K = 64
    spec = np.zeros((1, K), np.float32)
    spec[0, 20] = 1.0  # impulse at bin 20
    for alpha, direction in ((1.2, +1), (0.8, -1)):
        warp = tgt.piecewise_linear_warp(K, alpha=alpha)
        out = tgt.apply_vtln(torch.from_numpy(spec), torch.from_numpy(warp)).numpy()
        assert np.sign(int(np.argmax(out[0])) - 20) == direction
        want = jgt.apply_vtln(jnp.asarray(spec), jnp.asarray(warp))
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_vtln_estimation_tracks_frequency_shift(rng):
    """Speakers with scaled formants get warping factors on the right side,
    and the port's grid search equals the reference's: the same model
    (trained by the reference's EM), the same audio, the same factor and
    per-factor costs."""
    from rasr_tpu.align.aligner import BatchAligner as JaxAligner
    from rasr_tpu.align.aligner import linear_segmentation
    from rasr_tpu.align.graph import build_linear_graph
    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.models.hmm import HmmTopology
    from rasr_tpu.models.scorer import GmmFeatureScorer as JaxScorer
    from rasr_tpu.models.tying import MonophoneStateTying
    from rasr_tpu.ops.frontend import FeatureFrontend, FrontendConfig
    from rasr_tpu.train.em import GmmAccumulator, accumulate, estimate
    from rasr_tpu.train.vtln import estimate_warping_factor as jax_estimate
    from rasr_tpu_torch.align.aligner import BatchAligner
    from rasr_tpu_torch.models.scorer import GmmFeatureScorer
    from rasr_tpu_torch.ops.frontend import FrontendConfig as TorchFrontendConfig
    from rasr_tpu_torch.train.vtln import estimate_warping_factor, speaker_warping_table

    sr = 16000
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    M = tying.num_classes
    cfg = FrontendConfig(normalize="none")

    def synth(scale):
        def tone(f, d):
            t = np.arange(int(d * sr)) / sr
            return (0.3 * np.sin(2 * np.pi * f * scale * t)).astype(np.float32)
        s = (0.002 * rng.normal(size=int(0.1 * sr))).astype(np.float32)
        return np.concatenate([s, tone(800, 0.2), tone(2400, 0.2), s])

    # a model trained on scale-1.0 audio by the reference's EM
    train = np.stack([synth(1.0) for _ in range(3)])
    feats, nf = FeatureFrontend(cfg)(train, np.full(3, train.shape[1]))
    nf = np.asarray(nf)
    graphs = [build_linear_graph("AB", lex, tying, topo) for _ in range(3)]
    model = MixtureSet.single_density(np.zeros((M, 16), np.float32),
                                      np.ones((M, 16), np.float32))
    labels = linear_segmentation(graphs, nf)
    acc = GmmAccumulator.zeros(M, 1, 16)
    accumulate(acc, model, np.asarray(feats), labels)
    model = estimate(acc)
    for _ in range(2):
        als = JaxAligner(JaxScorer(model, var_floor=0.1)).align(feats, graphs, nf)
        labels = np.full(feats.shape[:2], -1, np.int32)
        for i, al in enumerate(als):
            labels[i, : al.num_frames] = al.emission_ids
        acc = GmmAccumulator.zeros(*model.means.shape)
        accumulate(acc, model, np.asarray(feats), labels)
        model = estimate(acc, prev=model)

    port_aligner = BatchAligner(GmmFeatureScorer(convert.mixture_set_from_jax(model),
                                                 var_floor=0.1, device="cpu"))
    port_graphs = [convert.linear_graph_from_jax(g) for g in graphs[:2]]
    alphas = (0.85, 1.0, 1.18)
    results, per_speaker = {}, {}
    for scale in (0.85, 1.0, 1.18):
        utt = np.stack([synth(scale) for _ in range(2)])
        lengths = np.full(2, utt.shape[1])
        want_best, want = jax_estimate(
            utt, lengths, graphs[:2], lambda: JaxAligner(JaxScorer(model, var_floor=0.1)),
            cfg, alphas=alphas)
        best, scores = estimate_warping_factor(
            torch.from_numpy(utt), torch.from_numpy(lengths), port_graphs, port_aligner,
            TorchFrontendConfig(normalize="none"), alphas=alphas, device="cpu")
        assert best == want_best
        assert list(scores) == list(want)
        np.testing.assert_allclose([scores[a] for a in alphas], [want[a] for a in alphas],
                                   rtol=1e-5)
        results[scale] = best
        per_speaker[f"spk{scale}"] = scores
    assert speaker_warping_table(per_speaker) == {f"spk{s}": a for s, a in results.items()}
    # matched speaker picks neutral; shifted speakers pick shifted warps
    assert results[1.0] == 1.0
    assert results[1.18] != 1.0 or results[0.85] != 1.0
    if results[1.18] != 1.0 and results[0.85] != 1.0:
        assert (results[1.18] - 1.0) * (results[0.85] - 1.0) < 0
