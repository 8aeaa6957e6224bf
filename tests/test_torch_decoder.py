"""PyTorch port vs JAX: the frame-synchronous tree decoder (slices A-C).

Gates: pruning off, the port's best score equals an exhaustive search
(also under root_select and deferred_emission, with compact branch slots,
on the across-word network and under "arc" bigram lookahead); with K, H,
Kb and R set to bind, under each slice-B pruning option, and on slice C's
networks and lookaheads (compact slots covering the dense fan and at a
binding budget, the across-word network, bigram lookahead under "arc"
and "survivor" updates, trigram anchors over a 4-gram LM with the two-key
recombination), the port equals the JAX decoder (same words, records and
final beams; scores within 1e-4 relative, LM costs exact) on tie-free
random emissions; the planted two-word canary under both of bench.py's
canary configs and on the across-word network; ragged batches equal
per-utterance decodes.
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
from rasr_tpu.search.lookahead import build_bigram_lookahead as jax_build_bigram_lookahead
from rasr_tpu.search.tree import build_prefix_tree as jax_build_prefix_tree
from rasr_tpu_torch import convert
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.search.decoder import (
    BeamConfig, TreeDecoder, _Step, traceback, tree_to_device,
)
from rasr_tpu_torch.search.lookahead import build_bigram_lookahead
from rasr_tpu_torch.search.tree import build_prefix_tree
from rasr_tpu_torch.synthetic import HashTying
from tests.test_crossword import InterningTriphoneTying
from tests.test_crossword import _oracle_best as _crossword_oracle_best


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


def _oracle_best(lex, topo, tying, trans, lm, emissions, T, lm_scale, max_words=4,
                 items=("AB", "BA", "AA", "[SILENCE]")):
    """Brute force (tests/test_decoder.py): min over word sequences (with
    explicit optional silences) of forced-alignment cost + scaled LM."""
    eos = lm.vocab["</s>"]
    best = (np.inf, None)

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
        max_hyps=256, beam=1e9, word_end_limit=64, root_hyps=256, lm_scale=lm_scale), device="cpu")
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


def _assert_port_equals_jax(jtree, ttree, lm, num_classes, kw, seed, bla=(None, None),
                            n=(14, 11, 9), rnn=(None, None)):
    """Decode the same tie-free random emissions (14 frames) with the JAX
    decoder and the port under ``kw`` (and the lookahead pair ``bla`` and
    the RNN-fusion pair ``rnn``, JAX's and the port's) and the declared
    lengths ``n``: same words, word ends, record chains and scores, the
    same R records in every frame and the same final beams."""
    rng = np.random.default_rng(seed)
    emis = rng.uniform(0.0, 6.0, size=(3, 14, num_classes)).astype(np.float32)
    n = np.array(n)
    jax_decoder = jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig(**kw),
                                   bigram_la=bla[0], rnn_fusion=rnn[0])
    want = jax_decoder.decode_scores(emis, n)
    decoder = TreeDecoder(ttree, compile_ngram(lm), BeamConfig(**kw), bigram_la=bla[1],
                          rnn_fusion=rnn[1], device="cpu")
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
    if rnn[1] is None:
        np.testing.assert_array_equal(recs.lmcost.numpy(), lmcost)
    else:  # the fused RNN cost is float32 products
        np.testing.assert_allclose(recs.lmcost.numpy(), lmcost, rtol=1e-4, atol=1e-4)
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


@pytest.mark.parametrize("name", sorted(BINDING))
def test_matches_jax_with_binding_limits(rich_setup, name):
    lex, tying, lm, jtree, ttree = rich_setup
    _assert_port_equals_jax(jtree, ttree, lm, tying.num_classes, BINDING[name],
                            sorted(BINDING).index(name))


def _slice_b_system(homophones):
    """rich_setup's network under an LM whose unigram costs all differ:
    every root arc and every sibling arc then has its own lookahead-shaped
    cost, so the pre-emission scores that root_select, deferred_emission
    and expansion_limit rank are tie-free (the reference's root-select
    sort is unstable)."""
    lex = Lexicon()
    build_default_silence(lex)
    words = [("AB", "a b", 0.0), ("BA", "b a", 0.0), ("AA", "a a", 0.0), ("BAC", "b a c", 0.0),
             ("ABC", "a b c", 0.0), ("CA", "c a", 0.0)]
    if homophones:
        words.append(("AB2", "a b", -0.3))  # cheaper pronunciation, rarer word
    for orth, pron, score in words:
        lex.add_lemma([orth], [(pron.split(), score)])
    topo = HmmTopology(states_per_phone=3, silence_states=1)
    tying = HashTying(20011)
    trans = TransitionModel()
    sents = ([["AB", "BA", "CA"], ["ABC", "AA"], ["BAC", "BA"], ["CA", "AB"]]
             + [["AB"]] * 5 + [["BA"]] * 3 + [["CA"]] + [["AA"]] * 7 + [["ABC"]] * 3
             + [["BAC"]] + ([["AB2"]] if homophones else []))
    lm = NgramLm.train_from_text(sents, order=3)
    uni = {w: lm.score((), w) for w in lm.vocab.values()}
    assert len(set(uni.values())) == len(uni)
    kw = dict(lm_vocab=lm.vocab, lm_unigrams=uni)
    jtree = jax_build_prefix_tree(lex, tying, topo, trans, **kw)
    ttree = build_prefix_tree(lex, tying, topo, trans, **kw)
    assert ttree.max_word_ends == (2 if homophones else 1)
    return tying, lm, jtree, ttree, lex


@pytest.fixture(scope="module")
def slice_b_systems():
    return {h: _slice_b_system(h) for h in (False, True)}


SLICE_B = {
    # name: (homophones, BeamConfig fields); K, H, Kb, R bind throughout.
    # beam=2.0 binds on the root-select survivors, which often hold the
    # frame's best score.
    "root-select": (True, dict(max_hyps=10, word_end_limit=4, root_hyps=3, branch_hyps=3,
                               root_select=4, lm_scale=0.7, beam=2.0)),
    "root-select-deferred": (True, dict(max_hyps=10, word_end_limit=4, root_hyps=3,
                                        branch_hyps=3, root_select=4, lm_scale=0.7,
                                        deferred_emission=True)),
    # bench.py's canary config (bench.py:334-336)
    "bench-canary-config": (True, dict(max_hyps=64, word_end_limit=16, lm_scale=0.5,
                                       root_hyps=4, root_select=8, root_arc_limit=2,
                                       branch_hyps=16, deferred_emission=True)),
    "expansion-limit": (True, dict(max_hyps=8, word_end_limit=4, root_hyps=3, branch_hyps=2,
                                   expansion_limit=14, lm_scale=0.7)),
    "rank-lm-one-slot": (False, dict(max_hyps=8, word_end_limit=2, root_hyps=3,
                                     word_end_rank_lm=True, lm_scale=0.9)),
    "rank-lm-homophones": (True, dict(max_hyps=8, word_end_limit=1, root_hyps=3,
                                      word_end_rank_lm=True, lm_scale=2.0)),
    "root-arc-limit": (True, dict(max_hyps=12, word_end_limit=4, root_hyps=3, root_arc_limit=2,
                                  lm_scale=0.7)),
}


@pytest.mark.parametrize("name", sorted(SLICE_B))
def test_matches_jax_slice_b(slice_b_systems, monkeypatch, name):
    homophones, kw = SLICE_B[name]
    tying, lm, jtree, ttree, _ = slice_b_systems[homophones]
    # the emission draw: for the homophone ranking, one in which the
    # biased slot re-sort changes which records are selected
    seed = 104 if name == "rank-lm-homophones" else 100 + sorted(SLICE_B).index(name)
    # the root fan-out's live pre-emission scores must be distinct in
    # every frame, or the reference's unstable root-select sort may pick
    # another survivor than the port's stable one
    fanouts = []
    fanout = _Step._root_fanout

    def spy(self, *args):
        out = fanout(self, *args)
        fanouts.append(out[0])
        return out

    monkeypatch.setattr(_Step, "_root_fanout", spy)
    _assert_port_equals_jax(jtree, ttree, lm, tying.num_classes, kw, seed)
    assert fanouts
    for p_root in fanouts:
        for row in p_root.numpy():
            live = row[row < 1e29]
            assert len(np.unique(live)) == len(live)


def test_offline_finals_when_n_frames_exceeds_the_frames(slice_b_systems):
    """A declared length past the emissions' last frame: the offline
    decode takes the finals frozen at the last declared frame, which never
    came, so that utterance ends in the start hypothesis, as the
    reference's offline scan does (the streaming decoder's
    ``current_best`` instead takes the live beam at the frontier). The
    fixture of ``tests/test_torch_streaming.py::_slice_b_decoder``."""
    name = "root-select-deferred"
    homophones, kw = SLICE_B[name]
    tying, lm, jtree, ttree, _ = slice_b_systems[homophones]
    _assert_port_equals_jax(jtree, ttree, lm, tying.num_classes, kw,
                            100 + sorted(SLICE_B).index(name), n=(17, 14, 9))


#: decodes whose traceback payload is held against the reference's: every
#: slice-B option (and declared lengths past the last frame) and the
#: slice-C networks and lookaheads
WALKS = {
    **{f"slice-b:{k}": ("b", k, (14, 11, 9)) for k in sorted(SLICE_B)},
    "slice-b:n-frames-past-the-end": ("b", "root-select-deferred", (17, 14, 9)),
}


def _walk_case(systems, kind, name):
    """(JAX decoder, port decoder, emissions) of a slice-B or slice-C
    parity case, with its emission draw."""
    if kind == "b":
        homophones, kw = SLICE_B[name]
        tying, lm, jtree, ttree, _ = systems[homophones]
        seed, M, bla = (104 if name == "rank-lm-homophones" else 100 + sorted(SLICE_B).index(name),
                        tying.num_classes, (None, None))
    else:
        network, la, kw = SLICE_C[name]
        lm, (jtree, ttree), las = systems[network]
        seed, M, bla = 200 + sorted(SLICE_C).index(name), 20011, las[la] if la else (None, None)
    emis = np.random.default_rng(seed).uniform(0.0, 6.0, size=(3, 14, M)).astype(np.float32)
    return (jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig(**kw),
                             bigram_la=bla[0]),
            TreeDecoder(ttree, compile_ngram(lm), BeamConfig(**kw), bigram_la=bla[1],
                        device="cpu"),
            emis)


def _assert_walk_equals_reference(jax_decoder, decoder, emis, n):
    """The port's device walk is the reference's host payload: the same
    (lemma, frame, record id) rows and the best scores in the last row;
    ``results_from_device`` reads nothing else from the device."""
    want = np.asarray(jax_decoder.decode_scores_device(emis, np.array(n)))
    handle = decoder.decode_scores_device(emis, np.array(n))
    for col in (handle.records.lemma, handle.records.prev, handle.records.word,
                handle.records.lm):
        assert col.dtype == torch.int32
    got = traceback(handle)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (15, 3, 3)
    np.testing.assert_array_equal(got[:-1].numpy(), want[:-1])
    np.testing.assert_allclose(got[-1].numpy().view(np.float32),
                               want[-1].view(np.float32), rtol=1e-4)
    pulled = []
    cpu = torch.Tensor.cpu

    def spy(self, *args, **kw):
        pulled.append(tuple(self.shape))
        return cpu(self, *args, **kw)

    torch.Tensor.cpu = spy
    try:
        decoder.results_from_device(handle)
    finally:
        torch.Tensor.cpu = cpu
    assert pulled == [want.shape]


@pytest.mark.parametrize("case", sorted(WALKS))
def test_device_walk_equals_reference_slice_b(slice_b_systems, case):
    kind, name, n = WALKS[case]
    _assert_walk_equals_reference(*_walk_case(slice_b_systems, kind, name), n)


@pytest.fixture(scope="module")
def slice_c_systems(slice_b_systems):
    """The slice-B homophone system as three networks, each as the JAX
    package and the port build it: the within-word tree, the across-word
    network (grouped context roots, ``we_next`` re-entry, two final
    states) and the within-word tree under a 4-gram LM; with their
    word-set and first-phone bigram lookaheads (trigram anchors for the
    4-gram)."""
    tying, lm, jtree, ttree, lex = slice_b_systems[True]
    topo, trans = HmmTopology(states_per_phone=3, silence_states=1), TransitionModel()

    def trees(lm_, **kw):
        kw = dict(lm_vocab=lm_.vocab, lm_unigrams={w: lm_.score((), w) for w in lm_.vocab.values()},
                  **kw)
        return (jax_build_prefix_tree(lex, tying, topo, trans, **kw),
                build_prefix_tree(lex, tying, topo, trans, **kw))

    def lookaheads(pair, lm_, **kw):
        return (jax_build_bigram_lookahead(pair[0], lm_, num_classes=8, **kw),
                build_bigram_lookahead(pair[1], lm_, num_classes=8, **kw))

    across = trees(lm, across_word=True)
    assert across[1].num_final_states == 2 and int(across[1].we_next.max()) > 1
    lm4 = NgramLm.train_from_text(
        [["AB", "BA", "CA", "AA"], ["ABC", "AA", "BA", "CA"], ["BAC", "AB2", "BA", "AB"],
         ["CA", "AB", "ABC", "AA"], ["AB", "BA", "CA", "BAC"]], order=4)
    assert any(len(k) == 4 for k in lm4.ngrams)
    four = trees(lm4)
    return {
        "within": (lm, (jtree, ttree), {
            "word-set": lookaheads((jtree, ttree), lm),
            "first-phone": lookaheads((jtree, ttree), lm, granularity="first-phone")}),
        "across": (lm, across, {"word-set": lookaheads(across, lm)}),
        "4gram": (lm4, four, {"trigram": lookaheads(four, lm4, order=3)}),
    }


_TIGHT = dict(max_hyps=6, word_end_limit=3, root_hyps=2, branch_hyps=2, lm_scale=0.7)
_RSEL = dict(max_hyps=10, word_end_limit=4, root_hyps=3, branch_hyps=3, root_select=4,
             deferred_emission=True, lm_scale=0.7)
_ACROSS = dict(max_hyps=8, word_end_limit=4, root_hyps=3, branch_hyps=3, lm_scale=0.7)
SLICE_C = {
    # name: (network, lookahead, BeamConfig fields); K, H, Kb, R bind.
    # Compact slots: 4 cover the 2 hyps' fans (overflow degree <= 2)
    # exactly; 3 slots for 3 hyps truncate the worst selected hyps' arcs.
    "compact-covering": ("within", None, dict(_TIGHT, branch_width=4)),
    "compact-binding": ("within", None, dict(_TIGHT, branch_hyps=3, branch_width=3)),
    "across-word": ("across", None, _ACROSS),
    # (no deferred emission on the across-word network: the right-context
    # copies of a word's last phone tie on pre-emission score there)
    "across-word-production": ("across", None, dict(_RSEL, max_hyps=12, branch_hyps=4,
                                                    root_select=6, branch_width=7,
                                                    deferred_emission=False)),
    "bigram-arc": ("within", "word-set", _TIGHT),
    "bigram-arc-first-phone": ("within", "first-phone", _TIGHT),
    "bigram-arc-production": ("within", "word-set", _RSEL),
    "bigram-arc-across-word": ("across", "word-set", dict(_ACROSS, branch_width=5)),
    "survivor": ("within", "word-set", dict(_TIGHT, lookahead_update="survivor")),
    "survivor-production": ("within", "word-set", dict(_RSEL, lookahead_update="survivor")),
    "survivor-across-word": ("across", "word-set", dict(_ACROSS, branch_width=5,
                                                        lookahead_update="survivor")),
    "trigram-4gram-two-key": ("4gram", "trigram", dict(_ACROSS, force_unpacked_keys=True)),
}


@pytest.mark.parametrize("name", sorted(SLICE_C))
def test_matches_jax_slice_c(slice_c_systems, monkeypatch, name):
    network, la, kw = SLICE_C[name]
    lm, (jtree, ttree), las = slice_c_systems[network]
    fanouts, overflow = [], []
    fanout, branch_fan = _Step._root_fanout, _Step._branch_fan

    def spy_root(self, *args):
        out = fanout(self, *args)
        fanouts.append(out[0])
        return out

    def spy_branch(self, state, score, *args):
        # the live arcs of the selected hyps against the slot budget
        sel = torch.where(self.tree.branch_deg[state] > 0, score, 1e30)
        top = torch.sort(sel, dim=1, stable=True).indices[:, :self.kbranch]
        deg = torch.where(sel.gather(1, top) < 5e29, self.tree.branch_deg[state.gather(1, top)], 0)
        overflow.append(int(deg.sum(dim=1).max()) > self.cfg.branch_width)
        return branch_fan(self, state, score, *args)

    monkeypatch.setattr(_Step, "_root_fanout", spy_root)
    monkeypatch.setattr(_Step, "_branch_fan", spy_branch)
    _assert_port_equals_jax(jtree, ttree, lm, 20011, kw, 200 + sorted(SLICE_C).index(name),
                            las[la] if la else (None, None))
    # tie-free root select: every frame's live root pre-scores are
    # distinct (the reference's root-select sort is unstable)
    for p_root in fanouts if kw.get("root_select") else ():
        for row in p_root.numpy():
            live = row[row < 1e29]
            assert len(np.unique(live)) == len(live)
    if name.startswith("compact"):
        assert any(overflow) == (name == "compact-binding")


@pytest.mark.parametrize("name", sorted(SLICE_C))
def test_device_walk_equals_reference_slice_c(slice_c_systems, name):
    _assert_walk_equals_reference(*_walk_case(slice_c_systems, "c", name), (14, 11, 9))


@pytest.mark.parametrize("option", [
    dict(root_select=4096), dict(deferred_emission=True),
    dict(deferred_emission=True, root_select=4096),
])
def test_slice_b_pruning_off_equals_exhaustive_oracle(oracle_setup, rng, option):
    """root_select (R3 covering the fan-out) and deferred_emission stay
    exact with pruning off (tests/test_decoder.py:385-456)."""
    lex, topo, tying, trans, lm, tree = oracle_setup
    M, T, lm_scale = tying.num_classes, 7, 0.7
    dec = TreeDecoder(tree, compile_ngram(lm), BeamConfig(
        max_hyps=256, beam=1e9, word_end_limit=64, root_hyps=256, lm_scale=lm_scale, **option),
        device="cpu")
    for _ in range(2):
        emis = rng.uniform(0.0, 6.0, size=(1, T, M)).astype(np.float32)
        (res,) = dec.decode_scores(emis, np.array([T]))
        score, seq = _oracle_best(lex, topo, tying, trans, lm, emis, T, lm_scale)
        np.testing.assert_allclose(res.score, score, rtol=1e-4, atol=1e-3)
        assert [l.primary_orth for l in res.lemmas] == list(seq)


@pytest.fixture(scope="module")
def oracle_systems(oracle_setup):
    """Pruning-off systems with their brute-force oracles: oracle_setup's
    lexicon with a word AC (state "a" then has three successors, one of
    them a branch arc), tests/test_crossword.py's across-word system
    (context-sensitive interned triphones), and oracle_setup itself."""
    lex, topo, tying, trans, lm, tree = oracle_setup
    blex = Lexicon()
    build_default_silence(blex)
    for orth, pron in (("AB", "a b"), ("AA", "a a"), ("AC", "a c"), ("BA", "b a")):
        blex.add_lemma([orth], [(pron.split(), 0.0)])
    btying = MonophoneStateTying(blex, topo)
    blm = NgramLm.train_from_text(
        [["AB", "BA"], ["AC", "AA"], ["BA", "AC"], ["AB", "AC"]], order=2)
    btree = build_prefix_tree(blex, btying, topo, trans, lm_vocab=blm.vocab)
    assert tree_to_device(btree, "cpu").branch_deg.max() == 1

    xlex = Lexicon()
    build_default_silence(xlex)
    for orth, pron in (("AB", "a b"), ("BA", "b a"), ("A", "a")):
        xlex.add_lemma([orth], [(pron.split(), 0.0)])
    xtying = InterningTriphoneTying()
    xlm = NgramLm.train_from_text(
        [["AB", "BA"], ["AB", "A"], ["BA", "AB"], ["A", "BA"], ["AB", "BA"]], order=2)
    xtree = build_prefix_tree(xlex, xtying, topo, trans, lm_vocab=xlm.vocab, across_word=True)
    assert xtree.num_final_states == 2 and tree_to_device(xtree, "cpu").branch_deg.max() > 0

    def oracle(items):
        return lambda *a: _oracle_best(*a, items=items)

    return {
        "branchy": (blex, topo, btying, trans, blm, btree,
                    oracle(("AB", "AA", "AC", "BA", "[SILENCE]"))),
        "across": (xlex, topo, xtying, trans, xlm, xtree, _crossword_oracle_best),
        "within": (lex, topo, tying, trans, lm, tree, _oracle_best),
    }


SLICE_C_ORACLE = {
    # name: (system, bigram lookahead granularity, BeamConfig fields)
    "compact": ("branchy", None, dict(branch_width=4096)),
    "compact-production": ("branchy", None, dict(branch_width=4096, root_select=4096,
                                                 deferred_emission=True)),
    "across-word": ("across", None, {}),
    "across-word-compact": ("across", None, dict(branch_width=4096, deferred_emission=True)),
    "bigram-arc": ("within", "word-set", {}),
    "bigram-arc-first-phone": ("within", "first-phone", dict(root_select=4096)),
    "bigram-arc-across-word": ("across", "word-set", dict(branch_width=4096)),
}


@pytest.mark.parametrize("name", sorted(SLICE_C_ORACLE))
def test_slice_c_pruning_off_equals_exhaustive_oracle(oracle_systems, name):
    """Compact slots covering every fan, the across-word network and
    "arc" bigram lookahead stay exact with pruning off (tests/
    test_branch_width.py:101, test_crossword.py:155, test_decoder.py:542)."""
    system, la, option = SLICE_C_ORACLE[name]
    lex, topo, tying, trans, lm, tree, oracle = oracle_systems[system]
    bla = None if la is None else build_bigram_lookahead(tree, lm, num_classes=4,
                                                         granularity=la)
    M, T, lm_scale = tying.num_classes, 6, 0.7
    dec = TreeDecoder(tree, compile_ngram(lm), BeamConfig(
        max_hyps=256, beam=1e9, word_end_limit=64, root_hyps=256, lm_scale=lm_scale, **option),
        bigram_la=bla, device="cpu")
    rng = np.random.default_rng(sorted(SLICE_C_ORACLE).index(name))
    for _ in range(2):
        emis = rng.uniform(0.0, 6.0, size=(1, T, M)).astype(np.float32)
        (res,) = dec.decode_scores(emis, np.array([T]))
        score, seq = oracle(lex, topo, tying, trans, lm, emis, T, lm_scale)
        np.testing.assert_allclose(res.score, score, rtol=1e-4, atol=1e-3)
        assert [l.primary_orth for l in res.lemmas] == list(seq)


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
                                                          lm_scale=0.5), device="cpu")
    (res,) = dec.decode_scores(torch.from_numpy(emis), np.array([len(seq)]))
    assert [l.primary_orth for l in res.lemmas] == ["[SILENCE]", "AB"]
    assert res.word_ends == [1, 5]
    assert res.orth == "AB"


def test_planted_canary_slice_b():
    """The same plant under bench.py's second canary config: root select,
    deferred emission and the branch / root caps (bench.py:334-336)."""
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
    dec = TreeDecoder(tree, compile_ngram(lm), BeamConfig(
        max_hyps=64, word_end_limit=16, lm_scale=0.5, root_hyps=4, root_select=8,
        root_arc_limit=2, branch_hyps=16, deferred_emission=True), device="cpu")
    (res,) = dec.decode_scores(torch.from_numpy(emis), np.array([len(seq)]))
    assert [l.primary_orth for l in res.lemmas] == ["[SILENCE]", "AB"]
    assert res.word_ends == [1, 5]


@pytest.mark.parametrize("beam", [
    dict(max_hyps=64, word_end_limit=16, lm_scale=0.5),
    dict(max_hyps=64, word_end_limit=16, lm_scale=0.5, root_hyps=4, root_select=8,
         root_arc_limit=2, branch_hyps=16, deferred_emission=True),
])
def test_planted_canary_across_word(beam):
    """The plant on the across-word network of the same lexicon: the
    monophone tying collapses its contexts (tests/test_crossword.py:177),
    so the JAX decoder and the port both read [SILENCE] AB @ [1, 5] under
    both of bench.py's canary configs (chip_smoke.py's third canary)."""
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    lm = NgramLm.train_from_text([["AB", "BA"], ["BA", "AB"]], order=2)
    kw = dict(lm_vocab=lm.vocab, across_word=True)
    jtree = jax_build_prefix_tree(lex, tying, topo, TransitionModel(), **kw)
    tree = build_prefix_tree(lex, tying, topo, TransitionModel(), **kw)
    assert tree.num_final_states == 2 and tree.we_next is not None

    def cls_of(sym):
        return tying.classify(AllophoneState(Allophone(lex.phonemes[sym].id), 0))

    seq = [cls_of("si")] * 2 + [cls_of("a")] * 2 + [cls_of("b")] * 2
    emis = np.full((1, len(seq), tying.num_classes), 50.0, np.float32)
    for t, c in enumerate(seq):
        emis[0, t, c] = 0.0
    (want,) = jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig(**beam)).decode_scores(
        emis, np.array([len(seq)]))
    (res,) = TreeDecoder(tree, compile_ngram(lm), BeamConfig(**beam), device="cpu").decode_scores(
        torch.from_numpy(emis), np.array([len(seq)]))
    for r in (want, res):
        assert [l.primary_orth for l in r.lemmas] == ["[SILENCE]", "AB"]
        assert r.word_ends == [1, 5]
    np.testing.assert_allclose(res.score, want.score, rtol=1e-5)


def test_batched_ragged_equals_single(rich_setup, rng):
    lex, tying, lm, jtree, ttree = rich_setup
    emis = rng.uniform(0.0, 6.0, size=(3, 10, tying.num_classes)).astype(np.float32)
    n = torch.tensor([5, 10, 7])
    dec = TreeDecoder(ttree, compile_ngram(lm), BeamConfig(max_hyps=64, word_end_limit=16,
                                                           lm_scale=0.7), device="cpu")
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
                                                           lm_scale=0.7), device="cpu")
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
    carried = convert.tree_tables_from_jax(jdecoder.tables, device="cpu")
    native = tree_to_device(ttree, device="cpu")
    for f in dataclasses.fields(native):
        a, b = getattr(carried, f.name), getattr(native, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f.name)
        else:
            assert a == b, f.name
    cfg = BeamConfig(max_hyps=16, word_end_limit=4, root_hyps=2, lm_scale=0.7)
    emis = rng.uniform(0.0, 6.0, size=(1, 8, tying.num_classes)).astype(np.float32)
    a = TreeDecoder(jtree, convert.ngram_tables_from_jax(jdecoder.lm, "cpu"), cfg,
                    tables=carried, device="cpu")
    b = TreeDecoder(ttree, compile_ngram(lm), cfg, device="cpu")
    assert a.decode_scores(emis, [8])[0].words == b.decode_scores(emis, [8])[0].words


def test_across_word_tree_tables_convert_from_jax(slice_c_systems):
    """The JAX decoder's tables of the across-word network (``we_next``
    re-entries, grouped roots in the branch CSR) carry across equal to the
    port's own, and decode the same."""
    lm, (jtree, ttree), _ = slice_c_systems["across"]
    jdecoder = jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig())
    carried = convert.tree_tables_from_jax(jdecoder.tables, device="cpu")
    native = tree_to_device(ttree, device="cpu")
    assert int(native.we_next.max()) > 1
    for f in dataclasses.fields(native):
        a, b = getattr(carried, f.name), getattr(native, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f.name)
        else:
            assert a == b, f.name
    emis = np.random.default_rng(4).uniform(0.0, 6.0, size=(2, 10, 20011)).astype(np.float32)
    a = TreeDecoder(jtree, compile_ngram(lm), BeamConfig(**_ACROSS), tables=carried, device="cpu")
    b = TreeDecoder(ttree, compile_ngram(lm), BeamConfig(**_ACROSS), device="cpu")
    assert [r.words for r in a.decode_scores(emis, [10, 7])] == [
        r.words for r in b.decode_scores(emis, [10, 7])]


@pytest.mark.parametrize("option", [dict(branch_width=16), dict(lookahead_update="survivor")])
def test_unported_beam_options_raise(slice_c_systems, option):
    """The two beam options that raised before slice C now decode and
    equal the JAX decoder: compact slots, and survivor updates of the
    word-set bigram lookahead."""
    lm, (jtree, ttree), las = slice_c_systems["within"]
    kw = dict(_TIGHT, **option)
    bla = las["word-set"] if "lookahead_update" in option else (None, None)
    _assert_port_equals_jax(jtree, ttree, lm, 20011, kw, 300, bla)


def test_unported_decoder_features_raise(slice_c_systems, oracle_setup):
    """A bigram lookahead decodes and equals the JAX decoder (also from the
    JAX decoder's own tables, carried across); so does a lookahead with
    junction re-entries (general WFST networks: tests/test_torch_wfst.py),
    which raised before it was ported. Beam partitioning is ported
    (tests/test_torch_parallel_decode.py); without a mesh its axis raises,
    as the reference asserts (RNN fusion: tests/test_torch_rnn_fusion.py)."""
    lm, (jtree, ttree), las = slice_c_systems["within"]
    _assert_port_equals_jax(jtree, ttree, lm, 20011, _RSEL, 301, las["word-set"])
    jtables = jdec.bigram_to_device(las["word-set"][0], jtree)
    _assert_port_equals_jax(jtree, ttree, lm, 20011, _RSEL, 301,
                            (las["word-set"][0], convert.bigram_tables_from_jax(jtables, "cpu")))
    *_, lm, tree = oracle_setup
    junction = dataclasses.replace(tree, we_next=np.zeros_like(tree.we_word))
    junction.we_next[int(np.flatnonzero(tree.we_word[:, 0] != -1)[0]), 0] = 1
    general = build_bigram_lookahead(junction, lm, num_classes=4)
    assert general.reentry
    emis = np.random.default_rng(302).uniform(0.0, 6.0, size=(2, 9, 3)).astype(np.float32)
    got = TreeDecoder(junction, compile_ngram(lm), bigram_la=general, device="cpu").decode_scores(
        emis, [9, 6])
    want = jdec.TreeDecoder(junction, jax_compile_ngram(lm), bigram_la=jax_build_bigram_lookahead(
        junction, lm, num_classes=4)).decode_scores(emis, [9, 6])
    for a, b in zip(got, want):
        assert a.words == b.words
        np.testing.assert_allclose(a.score, b.score, rtol=1e-4)
    dec = TreeDecoder(tree, compile_ngram(lm), device="cpu")
    with pytest.raises(ValueError, match="beam_axis requires a mesh"):
        dec.decode_scores(np.zeros((1, 2, 3), np.float32), [2], beam_axis="model")
