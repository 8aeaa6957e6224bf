"""PyTorch port vs JAX: the frame-synchronous tree decoder (slice A).

Gates: pruning off, the port's best score equals an exhaustive search;
with K, H, Kb and R set to bind, the port equals the JAX decoder (same
words, scores within 1e-4 relative) on tie-free random emissions; the
planted two-word canary; ragged batches equal per-utterance decodes.
"""

import dataclasses
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rasr_tpu.align.graph import build_linear_graph
from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.allophone import Allophone, AllophoneState
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.models.tying import MonophoneStateTying
from rasr_tpu.ops.viterbi import viterbi_align
from rasr_tpu.search import decoder as jdec
from rasr_tpu.search.tree import build_prefix_tree as jax_build_prefix_tree
from rasr_tpu_torch import convert
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder, tree_to_device
from rasr_tpu_torch.search.tree import build_prefix_tree
from rasr_tpu_torch.synthetic import HashTying


@pytest.fixture(scope="module")
def oracle_setup():
    """tests/test_decoder.py's exactness setup."""
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    lex.add_lemma(["AA"], [(["a", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    trans = TransitionModel(
        speech=Tdp(loop=1.0, forward=0.0, skip=math.inf, exit=0.5),
        silence=Tdp(loop=0.2, forward=0.5, skip=math.inf, exit=0.3),
    )
    lm = NgramLm.train_from_text(
        [["AB", "BA"], ["AB", "AA"], ["BA", "AB"], ["AB", "BA"]], order=2
    )
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    return lex, topo, tying, trans, lm, tree


@pytest.fixture(scope="module")
def rich_setup():
    """3-state phones with skips, homophones (two word-end slots on one
    state), a trigram LM and unigram lookahead: every slice-A path."""
    lex = Lexicon()
    build_default_silence(lex)
    for orth, pron, score in (("AB", "a b", 0.0), ("BA", "b a", 0.0), ("AA", "a a", 0.0),
                              ("BAC", "b a c", 0.0), ("ABC", "a b c", 0.0),
                              ("CA", "c a", 0.0), ("AB2", "a b", 0.4)):
        lex.add_lemma([orth], [(pron.split(), score)])
    topo = HmmTopology(states_per_phone=3, silence_states=1)
    # context-dependent hashed classes: every tree state emits its own
    # class, so random emissions give tie-free path scores (the reference
    # breaks score ties in no fixed order)
    tying = HashTying(20011)
    trans = TransitionModel()
    lm = NgramLm.train_from_text(
        [["AB", "BA", "CA"], ["ABC", "AA"], ["BAC", "AB2", "BA"], ["CA", "AB"]], order=3
    )
    uni = {w: lm.score((), w) for w in lm.vocab.values()}
    kw = dict(lm_vocab=lm.vocab, lm_unigrams=uni)
    jtree = jax_build_prefix_tree(lex, tying, topo, trans, **kw)
    ttree = build_prefix_tree(lex, tying, topo, trans, **kw)
    assert ttree.max_word_ends == 2
    assert len(set(ttree.emission_class[1:].tolist())) == ttree.num_states - 1
    return lex, tying, lm, jtree, ttree


def _oracle_best(lex, topo, tying, trans, lm, emissions, T, lm_scale, max_words=4):
    """Brute force (tests/test_decoder.py): min over word sequences (with
    explicit optional silences) of forced-alignment cost + scaled LM."""
    eos = lm.vocab["</s>"]
    best = (np.inf, None)
    items = ["AB", "BA", "AA", "[SILENCE]"]

    def lm_cost_of(seq):
        h = lm.start_history()
        c = 0.0
        for w in seq:
            if w == "[SILENCE]":
                continue
            wid = lm.vocab[w]
            c += lm_scale * lm.score(h, wid)
            h = lm.extended_history(h, wid)
        return c + lm_scale * lm.score(h, eos)

    for n in range(1, max_words + 1):
        for seq in itertools.product(items, repeat=n):
            g = build_linear_graph(" ".join(seq), lex, tying, topo, trans, optional_silence=False)
            if g.num_states > T:
                continue
            e = emissions[:, :, g.emission_ids]
            cost, _ = viterbi_align(
                jnp.asarray(e), jnp.asarray(g.loop[None]), jnp.asarray(g.fwd[None]),
                jnp.asarray(g.skip[None]), jnp.asarray(g.init[None]),
                jnp.asarray(g.final[None]), jnp.asarray([T]),
            )
            total = float(np.asarray(cost)[0]) + lm_cost_of(seq)
            if total < best[0]:
                best = (total, seq)
    return best


def test_pruning_off_equals_exhaustive_oracle(oracle_setup, rng):
    lex, topo, tying, trans, lm, tree = oracle_setup
    M, T, lm_scale = tying.num_classes, 7, 0.7
    dec = TreeDecoder(tree, compile_ngram(lm), BeamConfig(
        max_hyps=256, beam=1e9, word_end_limit=64, root_hyps=256, lm_scale=lm_scale))
    for _ in range(2):
        emis = rng.uniform(0.0, 6.0, size=(1, T, M)).astype(np.float32)
        (res,) = dec.decode_scores(emis, np.array([T]))
        score, seq = _oracle_best(lex, topo, tying, trans, lm, emis, T, lm_scale)
        np.testing.assert_allclose(res.score, score, rtol=1e-4, atol=1e-3)
        assert [l.primary_orth for l in res.lemmas] == list(seq)


BINDING = {
    # K, H, Kb and R all below the live candidate counts
    "tight": dict(max_hyps=6, word_end_limit=3, root_hyps=2, branch_hyps=2, lm_scale=0.7),
    "beams": dict(max_hyps=24, word_end_limit=8, root_hyps=3, branch_hyps=3, lm_scale=0.9,
                  beam=6.0, word_end_beam=0.5),
    "two-key": dict(max_hyps=10, word_end_limit=5, root_hyps=2, branch_hyps=1, lm_scale=0.5,
                    force_unpacked_keys=True),
    "no-lookahead": dict(max_hyps=8, word_end_limit=4, root_hyps=2, lm_scale=0.7,
                         lookahead_scale=0.0),
}


@pytest.mark.parametrize("name", sorted(BINDING))
def test_matches_jax_with_binding_limits(rich_setup, name):
    lex, tying, lm, jtree, ttree = rich_setup
    kw = BINDING[name]
    rng = np.random.default_rng(sorted(BINDING).index(name))
    emis = rng.uniform(0.0, 6.0, size=(3, 14, tying.num_classes)).astype(np.float32)
    n = np.array([14, 11, 9])
    jax_decoder = jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig(**kw))
    want = jax_decoder.decode_scores(emis, n)
    decoder = TreeDecoder(ttree, compile_ngram(lm), BeamConfig(**kw))
    handle = decoder.decode_scores_device(emis, n)
    got = decoder.results_from_device(handle)
    for a, b in zip(got, want):
        assert a.words == b.words
        assert a.word_ends == b.word_ends
        assert a.record_ids == b.record_ids
        np.testing.assert_allclose(a.score, b.score, rtol=1e-4)
    # every frame's R word-end records, not only the best path's
    lemma, score, prev, lmcost, word, lm_state = jax_decoder._last_records
    recs = handle.records
    np.testing.assert_array_equal(recs.lemma.numpy(), lemma)
    np.testing.assert_array_equal(recs.prev.numpy(), prev)
    np.testing.assert_array_equal(recs.word.numpy(), word)
    np.testing.assert_array_equal(recs.lm.numpy(), lm_state)
    np.testing.assert_allclose(recs.score.numpy(), score, rtol=1e-4)
    np.testing.assert_allclose(recs.lmcost.numpy(), lmcost, rtol=1e-5)
    # and each utterance's whole final beam, with its </s> costs
    fstate, flm, fscore, fbp, end_cost = jax_decoder._last_finals
    fin = handle.finals
    for b in range(3):
        def beam(st, lm_, sc, bp, end):
            live = sc < 1e29
            return sorted(zip(st[live], lm_[live], bp[live], np.round(sc[live], 3),
                              np.round(end[live], 4)))
        assert beam(fin.fstate[b].numpy(), fin.flm[b].numpy(), fin.fscore[b].numpy(),
                    fin.fbp[b].numpy(), handle.end_cost[b].numpy()) == beam(
            fstate[b], flm[b], fscore[b], fbp[b], end_cost[b])


def test_planted_canary():
    """bench.py's on-device canary: sil sil a a b b -> [SILENCE] AB."""
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    lm = NgramLm.train_from_text([["AB", "BA"], ["BA", "AB"]], order=2)
    tree = build_prefix_tree(lex, tying, topo, TransitionModel(), lm_vocab=lm.vocab)

    def cls_of(sym):
        return tying.classify(AllophoneState(Allophone(lex.phonemes[sym].id), 0))

    seq = [cls_of("si")] * 2 + [cls_of("a")] * 2 + [cls_of("b")] * 2
    emis = np.full((1, len(seq), tying.num_classes), 50.0, np.float32)
    for t, c in enumerate(seq):
        emis[0, t, c] = 0.0
    dec = TreeDecoder(tree, compile_ngram(lm), BeamConfig(max_hyps=64, word_end_limit=16,
                                                          lm_scale=0.5))
    (res,) = dec.decode_scores(torch.from_numpy(emis), np.array([len(seq)]))
    assert [l.primary_orth for l in res.lemmas] == ["[SILENCE]", "AB"]
    assert res.word_ends == [1, 5]
    assert res.orth == "AB"


def test_batched_ragged_equals_single(rich_setup, rng):
    lex, tying, lm, jtree, ttree = rich_setup
    emis = rng.uniform(0.0, 6.0, size=(3, 10, tying.num_classes)).astype(np.float32)
    n = torch.tensor([5, 10, 7])
    dec = TreeDecoder(ttree, compile_ngram(lm), BeamConfig(max_hyps=64, word_end_limit=16,
                                                           lm_scale=0.7))
    batch = dec.decode_scores(emis, n)
    for b in range(3):
        (single,) = dec.decode_scores(emis[b : b + 1, : n[b]], n[b : b + 1])
        assert batch[b].words == single.words
        np.testing.assert_allclose(batch[b].score, single.score, rtol=1e-5)


def test_device_handles_own_their_records(rich_setup, rng):
    """Two dispatches before either result is read: each handle carries
    its own records (no shared last-decode slot)."""
    lex, tying, lm, jtree, ttree = rich_setup
    dec = TreeDecoder(ttree, compile_ngram(lm), BeamConfig(max_hyps=32, word_end_limit=8,
                                                           lm_scale=0.7))
    e1 = rng.uniform(0.0, 6.0, size=(2, 9, tying.num_classes)).astype(np.float32)
    e2 = rng.uniform(0.0, 6.0, size=(2, 12, tying.num_classes)).astype(np.float32)
    want1 = dec.decode_scores(e1, [9, 8])
    want2 = dec.decode_scores(e2, [12, 12])
    h1 = dec.decode_scores_device(e1, torch.tensor([9, 8]))
    h2 = dec.decode_scores_device(e2, torch.tensor([12, 12]))
    for h, want in ((h2, want2), (h1, want1)):
        got = dec.results_from_device(h, names=["x", "y"])
        assert [r.words for r in got] == [r.words for r in want]
        assert [r.segment_name for r in got] == ["x", "y"]


def test_tree_tables_convert_from_jax(rich_setup, rng):
    lex, tying, lm, jtree, ttree = rich_setup
    jdecoder = jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig())
    carried = convert.tree_tables_from_jax(jdecoder.tables)
    native = tree_to_device(ttree)
    for f in dataclasses.fields(native):
        a, b = getattr(carried, f.name), getattr(native, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f.name)
        else:
            assert a == b, f.name
    cfg = BeamConfig(max_hyps=16, word_end_limit=4, root_hyps=2, lm_scale=0.7)
    emis = rng.uniform(0.0, 6.0, size=(1, 8, tying.num_classes)).astype(np.float32)
    a = TreeDecoder(jtree, convert.ngram_tables_from_jax(jdecoder.lm), cfg, tables=carried)
    b = TreeDecoder(ttree, compile_ngram(lm), cfg)
    assert a.decode_scores(emis, [8])[0].words == b.decode_scores(emis, [8])[0].words


@pytest.mark.parametrize("option", [
    dict(root_select=8), dict(deferred_emission=True), dict(branch_width=16),
    dict(expansion_limit=64), dict(root_arc_limit=4), dict(word_end_rank_lm=True),
    dict(lookahead_update="survivor"),
])
def test_unported_beam_options_raise(oracle_setup, option):
    *_, lm, tree = oracle_setup
    with pytest.raises(NotImplementedError):
        TreeDecoder(tree, compile_ngram(lm), BeamConfig(**option))


def test_unported_decoder_features_raise(oracle_setup):
    *_, lm, tree = oracle_setup
    with pytest.raises(NotImplementedError):
        TreeDecoder(tree, compile_ngram(lm), bigram_la=object())
    with pytest.raises(NotImplementedError):
        TreeDecoder(tree, compile_ngram(lm), rnn_fusion=object())
    dec = TreeDecoder(tree, compile_ngram(lm))
    with pytest.raises(NotImplementedError):
        dec.decode_scores(np.zeros((1, 2, 3), np.float32), [2], beam_axis="model")
