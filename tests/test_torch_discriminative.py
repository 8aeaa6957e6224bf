"""PyTorch port vs JAX: lattice-based MMI / MPE with EBW updates
(``train/discriminative.py``).

``tests/test_extras.py``'s cases as port == JAX: the EBW update of equal
accumulators; the MMI loop on the toy two-word task (numerator from the
forced alignment, denominator from the decode lattice: the reference's
lattice, carried across through its image, feeds both packages); the MPE
arc accuracies and accumulation. Accumulators agree to 1e-4 of their
largest entry (float32 sums), updated models and accuracies to 1e-5.
"""

import numpy as np
import pytest

from rasr_tpu.align import aligner as jal
from rasr_tpu.align import graph as jgr
from rasr_tpu.corpus import lexicon as jlex
from rasr_tpu.lattice.lattice import Lattice as JaxLattice
from rasr_tpu.lattice.lattice import LatticeArc as JaxLatticeArc
from rasr_tpu.lattice.lattice import decoder_lattice as jax_decoder_lattice
from rasr_tpu.models import gmm as jgmm
from rasr_tpu.models import hmm as jhmm
from rasr_tpu.models import scorer as jscorer
from rasr_tpu.models import tying as jtying
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram
from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu.search.tree import build_prefix_tree
from rasr_tpu.train import discriminative as jdt
from rasr_tpu.train import em as jem
from rasr_tpu_torch.align import aligner as tal
from rasr_tpu_torch.align import graph as tgr
from rasr_tpu_torch.corpus import lexicon as tlex
from rasr_tpu_torch.lattice.lattice import Lattice, LatticeArc
from rasr_tpu_torch.models import gmm as tgmm
from rasr_tpu_torch.models import hmm as thmm
from rasr_tpu_torch.models import scorer as tscorer
from rasr_tpu_torch.models import tying as ttying
from rasr_tpu_torch.train import discriminative as tdt
from rasr_tpu_torch.train import em as tem

JAX = dict(lex=jlex, hmm=jhmm, tying=jtying, gmm=jgmm, scorer=jscorer, graph=jgr, al=jal,
           dt=jdt, em=jem)
PORT = dict(lex=tlex, hmm=thmm, tying=ttying, gmm=tgmm, scorer=tscorer, graph=tgr, al=tal,
            dt=tdt, em=tem)


def _assert_acc_close(got, want):
    for name in ("count", "sum", "sumsq"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1.0),
                                   err_msg=name)


def _assert_models_close(got, want):
    for name in ("means", "variances", "weights"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.num_densities, want.num_densities)


def test_ebw_update_matches_jax(rng):
    """Equal data, both packages' accumulators and EBW updates: the means
    move toward the numerator statistics and away from the denominator's."""
    D = 2
    num_data = rng.normal(loc=+2.0, scale=0.5, size=(200, D)).astype(np.float32)
    den_data = rng.normal(loc=-2.0, scale=0.5, size=(200, D)).astype(np.float32)
    out = {}
    for tag, m in (("jax", JAX), ("port", PORT)):
        model = m["gmm"].MixtureSet.single_density(np.zeros((1, D), np.float32),
                                                  np.ones((1, D), np.float32))
        acc = m["dt"].MmiAccumulators.zeros(1, 1, D)
        kw = {} if tag == "jax" else dict(device="cpu")
        m["em"].accumulate(acc.num, model, num_data, np.zeros(200, np.int32), **kw)
        m["em"].accumulate(acc.den, model, den_data, np.zeros(200, np.int32), **kw)
        out[tag] = acc, m["dt"].ebw_update(model, acc)
    _assert_acc_close(out["port"][0].num, out["jax"][0].num)
    _assert_acc_close(out["port"][0].den, out["jax"][0].den)
    _assert_models_close(out["port"][1], out["jax"][1])
    assert np.all(out["port"][1].means[0, 0] > 0.1)


def _task(m, seed):
    """The toy two-word task in package ``m``: lexicon, topology, tying,
    transitions, a weakly separated single-density model and one noisy
    utterance of "AB" (sil a a b b sil) at its class means."""
    rng = np.random.default_rng(seed)
    lex = m["lex"].Lexicon()
    m["lex"].build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = m["hmm"].HmmTopology(states_per_phone=1, silence_states=1)
    tying = m["tying"].MonophoneStateTying(lex, topo)
    trans = m["hmm"].TransitionModel()
    M, D = tying.num_classes, 4
    means = rng.normal(size=(M, D)).astype(np.float32) * 1.5
    model = m["gmm"].MixtureSet.single_density(means, np.ones((M, D), np.float32))
    g = m["graph"].build_linear_graph("AB", lex, tying, topo, trans)
    plan = [0, 1, 1, 2, 2, 3]
    feats = np.stack([means[g.emission_ids[s]] + 0.3 * rng.normal(size=D).astype(np.float32)
                      for s in plan]).astype(np.float32)
    return lex, topo, tying, trans, model, g, feats


def _reference_lattice(seed):
    """The reference's decode lattice of the task's utterance, as both
    packages' Lattice."""
    lex, topo, tying, trans, model, g, feats = _task(JAX, seed)
    lm = NgramLm.train_from_text([["AB"], ["BA"]], order=1)
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    scorer = jscorer.GmmFeatureScorer(model)
    dec = TreeDecoder(tree, compile_ngram(lm), BeamConfig(max_hyps=64, word_end_limit=16))
    dec.decode_scores(np.asarray(scorer(feats[None])), np.array([feats.shape[0]]))
    lat = jax_decoder_lattice(dec, 0)
    assert len(lat.arcs) > 1
    return lat, Lattice.unpack(lat.pack())


def _scorer(m, model):
    kw = {} if m is JAX else dict(device="cpu")
    return m["scorer"].GmmFeatureScorer(model, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_mmi_accumulators_and_update_match_jax(seed):
    """The MMI loop: numerator from the forced alignment, denominator from
    the lattice's arc posteriors, then EBW; both packages agree and the
    updated model stays a valid mixture set."""
    jlat, tlat = _reference_lattice(seed)
    out = {}
    for tag, m, lat in (("jax", JAX, jlat), ("port", PORT, tlat)):
        lex, topo, tying, trans, model, g, feats = _task(m, seed)
        aligner = m["al"].BatchAligner(_scorer(m, model))
        acc = m["dt"].MmiAccumulators.zeros(model.means.shape[0], 1, feats.shape[1])
        (al,) = aligner.align(feats[None], [g], np.array([feats.shape[0]]))
        labels = np.full((1, feats.shape[0]), -1, np.int32)
        labels[0, : al.num_frames] = al.emission_ids
        kw = {} if m is JAX else dict(device="cpu")
        m["dt"].accumulate_numerator(acc, model, feats[None], labels, **kw)
        m["dt"].accumulate_denominator_from_lattice(acc, model, feats, lat, aligner, lex, tying,
                                                    topo, trans)
        out[tag] = acc, m["dt"].ebw_update(model, acc)
    (tacc, tnew), (jacc, jnew) = out["port"], out["jax"]
    assert tacc.num.count.sum() > 0 and tacc.den.count.sum() > 0
    _assert_acc_close(tacc.num, jacc.num)
    _assert_acc_close(tacc.den, jacc.den)
    _assert_models_close(tnew, jnew)
    assert np.all(tnew.variances > 0)
    np.testing.assert_allclose(tnew.weights.sum(axis=1), 1.0, atol=1e-5)
    assert tdt.mmi_objective(3.5, 1.25) == jdt.mmi_objective(3.5, 1.25)


def test_arc_accuracies_match_jax():
    """The reference's hand-made lattice (a correct word, a wrong word,
    silence) and a decode lattice against a reference alignment."""
    spec = ([(0, 1, 0, 1.0, 0.0), (0, 1, 1, 1.0, 0.0), (1, 2, 2, 1.0, 0.0)],
            np.array([0, 10, 12], np.int32), {2: 0.0}, ["HELLO", "WORLD", "[SIL]"])
    lats = (JaxLattice(3, [JaxLatticeArc(*a) for a in spec[0]], *spec[1:]),
            Lattice(3, [LatticeArc(*a) for a in spec[0]], *spec[1:]))
    got = tdt.arc_accuracies(lats[1], ["HELLO"], [(0, 10)])
    np.testing.assert_allclose(got, jdt.arc_accuracies(lats[0], ["HELLO"], [(0, 10)]))
    np.testing.assert_allclose(got, [1.0, 0.0, 0.0])
    jlat, tlat = _reference_lattice(0)
    np.testing.assert_allclose(tdt.arc_accuracies(tlat, ["AB"], [(1, 5)]),
                               jdt.arc_accuracies(jlat, ["AB"], [(1, 5)]), atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_mpe_accumulation_matches_jax(seed):
    """Posterior x (accuracy - expected accuracy) weights: positive ones
    to the numerator, negative ones to the denominator; the expected
    accuracy and both accumulators agree, and so do the EBW updates."""
    jlat, tlat = _reference_lattice(seed)
    out = {}
    for tag, m, lat in (("jax", JAX, jlat), ("port", PORT, tlat)):
        lex, topo, tying, trans, model, g, feats = _task(m, seed)
        acc = m["dt"].MmiAccumulators.zeros(model.means.shape[0], 1, feats.shape[1])
        expected = m["dt"].accumulate_mpe_from_lattice(
            acc, model, feats, lat, ["AB"], [(0, feats.shape[0])],
            m["al"].BatchAligner(_scorer(m, model)), lex, tying, topo, trans)
        out[tag] = expected, acc, m["dt"].ebw_update(model, acc)
    (te, tacc, tnew), (je, jacc, jnew) = out["port"], out["jax"]
    assert -1.0 <= te <= 1.0
    np.testing.assert_allclose(te, je, rtol=1e-5, atol=1e-6)
    _assert_acc_close(tacc.num, jacc.num)
    _assert_acc_close(tacc.den, jacc.den)
    _assert_models_close(tnew, jnew)
    assert np.all(tnew.variances > 0)
