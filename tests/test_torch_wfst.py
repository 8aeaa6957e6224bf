"""PyTorch port vs JAX: WFST decoding through the shared decoder
(``search/wfst.py``, the decoder's junction re-entry lookahead add-back).

The cases of ``tests/test_wfst.py`` run on both packages: the same
automaton (built once per package), ``compile_wfst``'s arrays equal, and
the port's decode gives the JAX decoder's words and scores (1e-4
relative: float32 sums in another order); on a grammar without loop
words (tie-free), every word-end record and final beam too, with the
lookahead's re-entries live. The
shaped == unshaped gate of ``test_wfst_bigram_lookahead_exact_shaping``
holds on the port as on the reference (scores 1e-5 relative + 1e-4
absolute, as there). One more case streams a WFST network in blocks and
holds it to the offline decode, exactly (the same block step). The
reference's partitioned-beam case needs a device mesh: beam
partitioning is not ported yet (ROADMAP Queue 1 item 11).
"""

import numpy as np
import pytest

from rasr_tpu.fsa.automaton import Automaton as JaxAutomaton
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.search import decoder as jdec
from rasr_tpu.search.lookahead import build_bigram_lookahead as jax_build_bigram_lookahead
from rasr_tpu.search.wfst import compile_wfst as jax_compile_wfst
from rasr_tpu_torch.fsa.automaton import Automaton
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder, bigram_to_device
from rasr_tpu_torch.search.lookahead import build_bigram_lookahead
from rasr_tpu_torch.search.streaming import StreamingDecoder
from rasr_tpu_torch.search.wfst import compile_wfst
from tests.test_torch_decoder import _assert_port_equals_jax


class _Lemma:
    def __init__(self, orth):
        self.primary_orth = orth
        self.special = None

    def eval_tokens(self):
        return [self.primary_orth]


def _grammar_fsa(cls):
    """(GO (LEFT|RIGHT)): GO = class 0, LEFT = class 1, RIGHT = class 2,
    one emitting arc per word (ilabel = class + 1, olabel = lemma + 1)."""
    fsa = cls()
    s0, s1, s2 = fsa.add_state(), fsa.add_state(), fsa.add_state()
    fsa.initial = s0
    fsa.add_arc(s0, s1, 1, 1, 0.0)
    fsa.add_arc(s1, s2, 2, 2, 0.0)
    fsa.add_arc(s1, s2, 3, 3, 0.5)  # RIGHT is costlier
    fsa.set_final(s2)
    return fsa


def _cyclic_grammar_fsa(cls):
    """A (B|C)* D: junction states and dense-arc cycles."""
    fsa = cls()
    s0, s1, s2 = fsa.add_state(), fsa.add_state(), fsa.add_state()
    fsa.initial = s0
    fsa.add_arc(s0, s1, 1, 1, 0.0)
    fsa.add_arc(s1, s1, 2, 2, 0.1)
    fsa.add_arc(s1, s1, 3, 3, 0.2)
    fsa.add_arc(s1, s2, 4, 4, 0.0)
    fsa.set_final(s2)
    return fsa


def _assert_trees_equal(got, want):
    for name in ("emission_class", "loop_cost", "arc_ptr", "arc_dst", "arc_cost", "we_word",
                 "we_cost", "we_lemma", "we_next"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.max_out_degree == want.max_out_degree


@pytest.fixture(scope="module")
def grammar():
    lemmas = [_Lemma(w) for w in ("GO", "LEFT", "RIGHT")]
    ttree = compile_wfst(_grammar_fsa(Automaton), num_classes=3, lemmas=lemmas, loop_cost=0.2)
    jtree = jax_compile_wfst(_grammar_fsa(JaxAutomaton), num_classes=3, lemmas=lemmas,
                             loop_cost=0.2)
    _assert_trees_equal(ttree, jtree)
    lm = NgramLm.train_from_text([["x"]], order=1)
    cfg = dict(max_hyps=16, word_end_limit=8)
    return (TreeDecoder(ttree, compile_ngram(lm), BeamConfig(**cfg), device="cpu"),
            jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig(**cfg)))


def _decode_both(grammar, emis):
    port, ref = grammar
    n = np.array([emis.shape[1]] * emis.shape[0])
    got, want = port.decode_scores(emis, n), ref.decode_scores(emis, n)
    for a, b in zip(got, want):
        assert a.words == b.words
        np.testing.assert_allclose(a.score, b.score, rtol=1e-4)
    return got


def test_wfst_decode_follows_emissions(grammar):
    emis = np.full((2, 6, 3), 5.0, np.float32)
    emis[:, :3, 0] = 0.0
    emis[0, 3:, 1] = 0.0
    emis[1, 3:, 2] = 0.0  # RIGHT acoustically enough to beat its 0.5 grammar cost
    assert [r.orth for r in _decode_both(grammar, emis)] == ["GO LEFT", "GO RIGHT"]


def test_wfst_grammar_cost_breaks_ties(grammar):
    emis = np.full((1, 4, 3), 5.0, np.float32)
    emis[0, :2, 0] = 0.0
    emis[0, 2:, 1:] = 0.0  # LEFT and RIGHT acoustically identical
    assert _decode_both(grammar, emis)[0].orth == "GO LEFT"


def test_wfst_rejects_ungrammatical(grammar):
    emis = np.full((1, 4, 3), 2.0, np.float32)
    emis[0, :2, 1] = 0.0  # LEFT acoustics first, then GO
    emis[0, 2:, 0] = 0.0
    (res,) = _decode_both(grammar, emis)
    assert not res.words or res.words[0] == "GO"


def _alternating_grammar_fsa(cls):
    """A (B C)* D: two junction states on a cycle, and no word that may
    follow itself, so no two segmentations of a frame span tie (under
    ``_cyclic_grammar_fsa``'s loop words, "C C" split at two frames sums
    the same costs, and the reference breaks such ties in no fixed order:
    ROADMAP Queue 3)."""
    fsa = cls()
    s0, s1, s2, s3 = (fsa.add_state() for _ in range(4))
    fsa.initial = s0
    fsa.add_arc(s0, s1, 1, 1, 0.0)
    fsa.add_arc(s1, s2, 2, 2, 0.1)
    fsa.add_arc(s2, s1, 3, 3, 0.2)
    fsa.add_arc(s1, s3, 4, 4, 0.0)
    fsa.set_final(s3)
    return fsa


def _wfst_system(fsa_fn, alternate):
    """A grammar network with a bigram LM over its words A-D (60 sentences
    A ... D drawn as in tests/test_wfst.py: middles of B / C, alternating
    B C pairs when ``alternate``), and both packages' re-entry
    lookaheads."""
    words = ["A", "B", "C", "D"]
    lemmas = [_Lemma(w) for w in words]
    rng = np.random.default_rng(5)
    sents = []
    for _ in range(60):
        k = int(rng.integers(0, 4))
        mid = (["B", "C"] * k if alternate
               else [words[1 + int(rng.integers(2))] for _ in range(k)])
        sents.append(["A"] + mid + ["D"])
    lm = NgramLm.train_from_text(sents, order=2)
    lm_words = {i: lm.vocab[w] for i, w in enumerate(words)}
    kw = dict(num_classes=4, lemmas=lemmas, loop_cost=0.3, lm_words=lm_words)
    ttree = compile_wfst(fsa_fn(Automaton), **kw)
    jtree = jax_compile_wfst(fsa_fn(JaxAutomaton), **kw)
    _assert_trees_equal(ttree, jtree)
    tbla = build_bigram_lookahead(ttree, lm, num_classes=6)
    jbla = jax_build_bigram_lookahead(jtree, lm, num_classes=6)
    assert tbla is not None and tbla.deep and tbla.reentry
    np.testing.assert_array_equal(tbla.sub_state, jbla.sub_state)
    np.testing.assert_array_equal(tbla.corr, jbla.corr)
    # junction states keep their own (non-sentinel) lookahead nodes, also
    # in the decoder's device tables
    junctions = np.unique(ttree.we_next[ttree.we_next > 0])
    sentinel = tbla.corr.shape[1] - 1
    assert junctions.size and (tbla.sub_state[junctions] < sentinel).all()
    tables = bigram_to_device(tbla, ttree, "cpu")
    assert tables.reentry and (tables.sub[junctions] < sentinel).all()
    assert tables.sub[ttree.num_states] == sentinel  # the padding state's row
    return lm, ttree, jtree, tbla, jbla


@pytest.fixture(scope="module")
def cyclic():
    return _wfst_system(_cyclic_grammar_fsa, alternate=False)


@pytest.fixture(scope="module")
def alternating():
    return _wfst_system(_alternating_grammar_fsa, alternate=True)


EXACT = dict(max_hyps=64, word_end_limit=32, root_hyps=16, lm_scale=1.0)


def test_wfst_bigram_lookahead_exact_shaping(cyclic):
    """Pruning off: the shaped decode (the re-entry add-back of each
    junction's correction) gives the unshaped decode's words and scores,
    on the port and against the JAX shaped decode."""
    lm, ttree, jtree, tbla, jbla = cyclic
    tables = compile_ngram(lm)
    plain = TreeDecoder(ttree, tables, BeamConfig(**EXACT), device="cpu")
    shaped = TreeDecoder(ttree, tables, BeamConfig(**EXACT), bigram_la=tbla, device="cpu")
    ref = jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig(**EXACT),
                           bigram_la=jbla)
    for seed in range(4):
        emis = np.random.default_rng(seed).uniform(0.0, 4.0, size=(2, 10, 4)).astype(np.float32)
        nf = np.array([10, 7])
        a, b, c = (d.decode_scores(emis, nf) for d in (plain, shaped, ref))
        for x, y, z in zip(a, b, c):
            assert x.words == y.words == z.words, (seed, x.words, y.words, z.words)
            np.testing.assert_allclose(x.score, y.score, rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(y.score, z.score, rtol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(max_hyps=6, word_end_limit=3, root_hyps=2, lm_scale=1.3),
    dict(max_hyps=8, word_end_limit=4, root_hyps=3, lm_scale=0.8, lookahead_update="survivor"),
    dict(max_hyps=8, word_end_limit=4, root_hyps=3, lm_scale=0.8, root_select=4,
         deferred_emission=True),
], ids=["binding", "survivor", "rsel-deferred"])
def test_wfst_reentry_lookahead_matches_jax(alternating, kw):
    """With K, R and H binding, the shaped WFST decode equals the JAX one:
    words, word ends, every frame's word-end records and the final beams."""
    lm, ttree, jtree, tbla, jbla = alternating
    _assert_port_equals_jax(jtree, ttree, lm, 4, kw, 11, bla=(jbla, tbla))


@pytest.mark.parametrize("split", [[5, 5, 4], [1] * 14])
def test_wfst_streamed_equals_offline(cyclic, split):
    """A WFST network with the re-entry lookahead, streamed in blocks:
    the offline decode's words, word ends, records and scores (the same
    block step, so ties break alike)."""
    lm, ttree, _, tbla, _ = cyclic
    dec = TreeDecoder(ttree, compile_ngram(lm), BeamConfig(max_hyps=8, word_end_limit=4,
                                                           root_hyps=3, lm_scale=0.8),
                      bigram_la=tbla, device="cpu")
    emis = np.random.default_rng(3).uniform(0.0, 4.0, size=(3, 14, 4)).astype(np.float32)
    n = np.array([14, 11, 9])
    offline = dec.results_from_device(dec.decode_scores_device(emis, n))
    sd = StreamingDecoder(dec).restart(3, n)
    t = 0
    for size in split:
        sd.feed(emis[:, t:t + size])
        t += size
    streamed = dec.results_from_device(sd.finalize_device())
    assert any(r.words for r in offline)
    for a, b in zip(streamed, offline):
        assert (a.words, a.word_ends, a.record_ids, a.score) == (
            b.words, b.word_ends, b.record_ids, b.score)
