"""PyTorch port vs JAX: alignment graphs, batched forced alignment, and
acoustic lattice rescoring.

Both packages build their own lexicon, tying and graphs from the same
description; the graphs are equal array for array and state for state.
The aligners run on the same seeded numpy scores: Viterbi state sequences
exact and scores 1e-5 relative; Baum-Welch weights (posteriors) 1e-5
absolute. ``Alignment.pack`` gives the reference's bytes. The reference's
oracles (``tests/test_align.py``: planted paths, the optional-silence
skip, ragged batches, Baum-Welch sharpness) run on the port's side.
"""

import numpy as np
import pytest
import torch

from rasr_tpu.align import aligner as jal
from rasr_tpu.align import graph as jgr
from rasr_tpu.corpus import lexicon as jlex
from rasr_tpu.lattice import lattice as jlat
from rasr_tpu.lattice import rescore as jrescore
from rasr_tpu.models import gmm as jgmm
from rasr_tpu.models import hmm as jhmm
from rasr_tpu.models import scorer as jscorer
from rasr_tpu.models import tying as jtying
from rasr_tpu_torch import convert
from rasr_tpu_torch.align import aligner as tal
from rasr_tpu_torch.align import graph as tgr
from rasr_tpu_torch.corpus import lexicon as tlex
from rasr_tpu_torch.lattice import lattice as tlat
from rasr_tpu_torch.lattice import rescore as trescore
from rasr_tpu_torch.models import gmm as tgmm
from rasr_tpu_torch.models import hmm as thmm
from rasr_tpu_torch.models import scorer as tscorer
from rasr_tpu_torch.models import tying as ttying
from rasr_tpu_torch.ops.viterbi import BIG

SCORE_RTOL, WEIGHT_ATOL = 1e-5, 1e-5

WORDS = [("AB", [["a", "b"]]), ("BA", [["b", "a"]]), ("CAB", [["c", "a", "b"], ["c", "b"]]),
         ("ACA", [["a", "c", "a"]]), ("BC", [["b", "c"], ["b", "a", "c"]])]


def _lexicon(mod, unknown=False):
    lex = mod.Lexicon()
    mod.build_default_silence(lex)
    for orth, prons in WORDS:
        lex.add_lemma([orth], [(p, 0.0) for p in prons])
    if unknown:
        lex.add_lemma(["[UNKNOWN]"], [(["si"], 0.0)], special="unknown")
    return lex


class HashTying:
    """A context-dependent tying that works on either package's
    allophone states (a hash of the triphone and state)."""

    num_classes = 29

    def classify(self, st):
        al = st.allophone
        h = al.center * 7919 + al.left * 104729 + al.right * 1299709 + st.state * 15485863
        return h % self.num_classes


def _systems(tying="mono", unknown=False, states_per_phone=2):
    """(jax (lex, tying, topo), port (lex, tying, topo))."""
    out = []
    for lexmod, hmm, tymod in ((jlex, jhmm, jtying), (tlex, thmm, ttying)):
        lex = _lexicon(lexmod, unknown)
        topo = hmm.HmmTopology(states_per_phone=states_per_phone, silence_states=1)
        ty = tymod.MonophoneStateTying(lex, topo) if tying == "mono" else HashTying()
        out.append((lex, ty, topo))
    return out


def _state_tuple(st):
    a = st.allophone
    return (a.center, a.left, a.right, a.boundary, st.state)


def _assert_graphs_equal(tg, jg):
    for f in ("emission_ids", "loop", "fwd", "skip", "init", "final", "lemma_of_state"):
        np.testing.assert_array_equal(getattr(tg, f), np.asarray(getattr(jg, f)), err_msg=f)
    assert [_state_tuple(s) for s in tg.states] == [_state_tuple(s) for s in jg.states]
    assert [l.orth for l in tg.lemmas] == [l.orth for l in jg.lemmas]


GRAPH_CASES = [
    ("AB", {}, "mono"),
    ("AB BA CAB", {}, "mono"),
    ("CAB BC", dict(pronunciation_index=1), "hash"),
    ("CAB BC ACA", dict(pronunciation_index=[1, 0, 0]), "hash"),
    ("ACA BC", dict(optional_silence=False), "hash"),
    ("AB CAB BC", dict(optional_silence=False, across_word=True), "hash"),
    ("AB NOPE BA", {}, "unknown"),
]


@pytest.mark.parametrize("orth,kw,tying", GRAPH_CASES)
def test_graph_matches_jax(orth, kw, tying):
    (jlx, jty, jtopo), (tlx, tty, ttopo) = _systems(
        "mono" if tying == "unknown" else tying, unknown=tying == "unknown")
    jg = jgr.build_linear_graph(orth, jlx, jty, jtopo, **kw)
    tg = tgr.build_linear_graph(orth, tlx, tty, ttopo, **kw)
    _assert_graphs_equal(tg, jg)
    _assert_graphs_equal(convert.linear_graph_from_jax(jg), jg)


def test_orth_errors_match_jax():
    (jlx, jty, jtopo), (tlx, tty, ttopo) = _systems()
    assert [l.primary_orth for l in tgr.orth_to_lemmas("AB BA AB", tlx)] == ["AB", "BA", "AB"]
    for mod, lx, ty, topo in ((jgr, jlx, jty, jtopo), (tgr, tlx, tty, ttopo)):
        with pytest.raises(mod.OrthographyError):
            mod.orth_to_lemmas("NOPE", lx)
        with pytest.raises(mod.OrthographyError):
            mod.build_linear_graph("", lx, ty, topo)
        with pytest.raises(ValueError, match="across_word"):
            mod.build_linear_graph("AB", lx, ty, topo, across_word=True)


ORTHS = ["AB BA", "CAB", "BC ACA AB", "BA"]


def _graph_batch(tying="hash"):
    (jlx, jty, jtopo), (tlx, tty, ttopo) = _systems(tying)
    jgs = [jgr.build_linear_graph(o, jlx, jty, jtopo) for o in ORTHS]
    tgs = [tgr.build_linear_graph(o, tlx, tty, ttopo) for o in ORTHS]
    return jgs, tgs, tty.num_classes


def test_pad_graphs_and_linear_segmentation_match_jax():
    jgs, tgs, _ = _graph_batch()
    for a, b in zip(tal._pad_graphs(tgs), jal._pad_graphs(jgs)):
        np.testing.assert_array_equal(a, b)
    n = np.array([30, 7, 25, 12])
    np.testing.assert_array_equal(tal.linear_segmentation(tgs, n),
                                  jal.linear_segmentation(jgs, n))


def _scores(seed, M, B=4, T=30):
    return np.random.default_rng(seed).uniform(0.0, 8.0, size=(B, T, M)).astype(np.float32)


@pytest.mark.parametrize("mode", ["viterbi", "baum-welch"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_scores_matches_jax(mode, seed):
    jgs, tgs, M = _graph_batch()
    scores = _scores(seed, M)
    n = np.array([30, 21, 30, 9])
    names = [f"s{i}" for i in range(4)]
    want = jal.BatchAligner(None, mode).align_scores(scores, jgs, n, names)
    got = tal.BatchAligner(None, mode).align_scores(torch.from_numpy(scores), tgs, n, names)
    for a, b in zip(got, want):
        assert a.segment_name == b.segment_name
        np.testing.assert_array_equal(a.state_indices, b.state_indices)
        np.testing.assert_array_equal(a.emission_ids, b.emission_ids)
        np.testing.assert_allclose(a.score, b.score, rtol=SCORE_RTOL)
        np.testing.assert_allclose(a.weights, b.weights, atol=WEIGHT_ATOL)
        assert a.pack() == b.pack() if mode == "viterbi" else len(a.pack()) == len(b.pack())


def _gmm_pair(seed, M, D=5):
    rng = np.random.default_rng(seed)
    ms = tgmm.MixtureSet(
        means=rng.normal(size=(M, 2, D)).astype(np.float32) * 2,
        variances=(0.5 + rng.uniform(size=(M, 2, D))).astype(np.float32),
        weights=np.full((M, 2), 0.5, np.float32),
        num_densities=np.full(M, 2, np.int32))
    jms = jgmm.MixtureSet(ms.means, ms.variances, ms.weights, ms.num_densities)
    return (jscorer.GmmFeatureScorer(jms),
            tscorer.GmmFeatureScorer(convert.mixture_set_from_jax(jms), device="cpu"), rng)


def test_gamma_and_align_through_the_scorer_match_jax():
    """``gamma()`` and ``align()`` score features with the GMM scorer first
    (the plain version on the CPU): totals 1e-5 relative, posteriors
    1e-5 absolute, emission ids of the padded graphs equal."""
    jgs, tgs, M = _graph_batch()
    js, ts, rng = _gmm_pair(3, M)
    feats = rng.normal(size=(4, 30, 5)).astype(np.float32)
    n = np.array([30, 21, 30, 9])
    jt, jgam, jids = jal.BatchAligner(js, "baum-welch").gamma(feats, jgs, n)
    tt, tgam, tids = tal.BatchAligner(ts, "baum-welch").gamma(torch.from_numpy(feats), tgs, n)
    np.testing.assert_allclose(tt, jt, rtol=SCORE_RTOL)
    np.testing.assert_allclose(tgam, jgam, atol=WEIGHT_ATOL)
    np.testing.assert_array_equal(tids, jids)
    for a, b in zip(tal.BatchAligner(ts).align(torch.from_numpy(feats), tgs, n),
                    jal.BatchAligner(js).align(feats, jgs, n)):
        np.testing.assert_allclose(a.score, b.score, rtol=1e-4)


def test_alignment_pack_is_the_reference_format():
    al = tal.Alignment("seg", np.arange(5, dtype=np.int32), np.arange(5, dtype=np.int32) * 2,
                       score=1.5, weights=np.linspace(0, 1, 5).astype(np.float32))
    ref = jal.Alignment("seg", al.emission_ids, al.state_indices, 1.5, al.weights)
    assert al.pack() == ref.pack()
    back = tal.Alignment.unpack("seg", ref.pack(), 1.5)
    np.testing.assert_array_equal(back.state_indices, al.state_indices)
    np.testing.assert_array_equal(back.emission_ids, al.emission_ids)
    np.testing.assert_array_equal(back.weights, al.weights)
    with pytest.raises(ValueError, match="mode"):
        tal.BatchAligner(None, mode="forced")


# -------------------------------- the reference's oracles, on the port
@pytest.fixture
def mono():
    lex = tlex.Lexicon()
    tlex.build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = thmm.HmmTopology(states_per_phone=2, silence_states=1)
    return lex, topo, ttying.MonophoneStateTying(lex, topo)


def _planted_scorer(rng, tying, D=4):
    means = rng.normal(size=(tying.num_classes, D)).astype(np.float32) * 3
    ms = tgmm.MixtureSet.single_density(means, np.ones_like(means) * 0.1)
    return means, tscorer.GmmFeatureScorer(ms, device="cpu")


def test_graph_structure(mono):
    lex, topo, tying = mono
    g = tgr.build_linear_graph("AB", lex, tying, topo)
    assert g.num_states == 6
    assert g.lemma_of_state.tolist() == [-1, 0, 0, 0, 0, -1]
    assert g.init[0] == 0.0 and g.init[1] == 0.0
    assert np.all(g.init[2:] >= BIG / 2)
    assert g.final[5] < BIG / 2 and g.final[4] < BIG / 2
    assert g.skip[1] >= BIG / 2


def test_forced_alignment_recovers_planted_path(mono, rng):
    lex, topo, tying = mono
    means, scorer = _planted_scorer(rng, tying)
    g = tgr.build_linear_graph("AB", lex, tying, topo)
    plan = [0] * 2 + [1] * 3 + [2] * 2 + [3] * 2 + [4] * 3 + [5] * 2
    feats = np.stack([means[g.emission_ids[s]] for s in plan])[None]
    (al,) = tal.BatchAligner(scorer).align(torch.from_numpy(feats), [g], np.array([len(plan)]),
                                           ["seg1"])
    assert al.num_frames == len(plan) and al.state_indices.tolist() == plan
    np.testing.assert_array_equal(al.emission_ids, g.emission_ids[plan])


def test_alignment_skips_optional_silence(mono, rng):
    lex, topo, tying = mono
    means, scorer = _planted_scorer(rng, tying)
    g = tgr.build_linear_graph("AB BA", lex, tying, topo)
    plan = [s for s in [1, 2, 3, 4, 6, 7, 8, 9] for _ in range(2)]
    assert g.lemma_of_state.tolist() == [-1, 0, 0, 0, 0, -1, 1, 1, 1, 1, -1]
    feats = np.stack([means[g.emission_ids[s]] for s in plan])[None]
    (al,) = tal.BatchAligner(scorer).align(torch.from_numpy(feats), [g], np.array([len(plan)]))
    assert al.state_indices.tolist() == plan


def test_batch_alignment_ragged(mono, rng):
    lex, topo, tying = mono
    means, scorer = _planted_scorer(rng, tying)
    g1 = tgr.build_linear_graph("AB", lex, tying, topo)
    g2 = tgr.build_linear_graph("BA AB", lex, tying, topo)
    plan1, plan2 = [1, 1, 2, 3, 4], [1, 2, 3, 4, 5, 6, 7, 8, 9]
    feats = np.zeros((2, len(plan2), 4), np.float32)
    for t, s in enumerate(plan1):
        feats[0, t] = means[g1.emission_ids[s]]
    for t, s in enumerate(plan2):
        feats[1, t] = means[g2.emission_ids[s]]
    als = tal.BatchAligner(scorer).align(torch.from_numpy(feats), [g1, g2],
                                         np.array([len(plan1), len(plan2)]))
    assert als[0].state_indices.tolist() == plan1
    assert als[1].state_indices.tolist() == plan2


def test_baum_welch_mode(mono, rng):
    lex, topo, tying = mono
    means, scorer = _planted_scorer(rng, tying)
    g = tgr.build_linear_graph("AB", lex, tying, topo)
    plan = [0, 1, 1, 2, 3, 4, 5]
    feats = np.stack([means[g.emission_ids[s]] for s in plan])[None]
    (al,) = tal.BatchAligner(scorer, mode="baum-welch").align(
        torch.from_numpy(feats), [g], np.array([len(plan)]))
    assert al.state_indices.tolist() == plan
    assert np.all(al.weights > 0.9)


# ------------------------------------------------ lattice AM rescoring
def _lattices(jlx):
    """The same lattice in both packages: words over spans, an epsilon
    arc, an arc too short for its word and an unknown orthography."""
    orths = [l.primary_orth for l in jlx.lemmata] + ["NOPE"]
    arcs = [(0, 1, orths.index("AB")), (1, 2, orths.index("CAB")), (0, 2, orths.index("BC")),
            (2, 3, -1), (1, 3, orths.index("ACA")), (2, 4, orths.index("BA")),
            (3, 4, orths.index("NOPE"))]
    times = np.array([0, 8, 20, 20, 27], np.int32)
    out = []
    for mod in (jlat, tlat):
        out.append(mod.Lattice(
            num_nodes=5, node_time=times, final_scores={4: 0.0}, lemma_orths=list(orths),
            arcs=[mod.LatticeArc(a, b, lem, 1.0, 2.0) for a, b, lem in arcs]))
    return out


def test_rescore_am_matches_jax():
    """Every arc re-aligned over its span (min over pronunciation
    variants); impossible and unknown arcs BIG, epsilon 0; 1e-5 relative."""
    (jlx, jty, jtopo), (tlx, tty, ttopo) = _systems("hash")
    jl, tl = _lattices(jlx)
    emis = _scores(5, jty.num_classes, B=1, T=27)[0]
    want = jrescore.rescore_am(jl, emis, jlx, jty, jtopo)
    got = trescore.rescore_am(tl, torch.from_numpy(emis), tlx, tty, ttopo)
    am_w = np.array([a.am_score for a in want.arcs])
    am_g = np.array([a.am_score for a in got.arcs])
    np.testing.assert_allclose(am_g, am_w, rtol=SCORE_RTOL)
    assert (am_g >= BIG / 2).sum() >= 1 and 0.0 in am_g
    assert [a.lm_score for a in got.arcs] == [a.lm_score for a in tl.arcs]
    with pytest.raises(ValueError, match="feature cache"):
        trescore.rescore_am(tl, emis[:10], tlx, tty, ttopo, device="cpu")
