"""The port's JAX-free copy of the within-word prefix-tree builder must
equal ``rasr_tpu.search.tree`` field by field."""

import math

import numpy as np
import pytest

from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.tying import MonophoneStateTying
from rasr_tpu.search import tree as jtree
from rasr_tpu_torch.search import tree as ttree

ARRAYS = ("emission_class", "loop_cost", "arc_ptr", "arc_dst", "arc_cost", "we_word",
          "we_cost", "we_lemma", "lookahead", "we_next")


def _setup(states_per_phone):
    lex = Lexicon()
    build_default_silence(lex)
    for orth, pron in (("AB", "a b"), ("BA", "b a"), ("AA", "a a"), ("BAB", "b a b"),
                       ("ABC", "a b c"), ("C", "c"), ("AB2", "a b")):
        lex.add_lemma([orth], [(pron.split(), 0.25 * len(orth))])
    topo = HmmTopology(states_per_phone=states_per_phone, silence_states=1)
    lm = NgramLm.train_from_text([["AB", "BA"], ["ABC", "C", "AA"], ["BAB", "AB2"]], order=2)
    return lex, topo, MonophoneStateTying(lex, topo), lm


@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("skip_scope,states", [("word", 3), ("phone", 3), ("word", 1)])
def test_prefix_tree_equals_reference(lookahead, skip_scope, states):
    lex, topo, tying, lm = _setup(states)
    trans = TransitionModel(
        speech=Tdp(loop=1.0, forward=0.0, skip=2.0, exit=0.5),
        silence=Tdp(loop=0.2, forward=0.5, skip=math.inf, exit=0.3),
    )
    uni = {w: lm.score((), w) for w in lm.vocab.values()} if lookahead else None
    kw = dict(lm_vocab=lm.vocab, lm_unigrams=uni, skip_scope=skip_scope)
    want = jtree.build_prefix_tree(lex, tying, topo, trans, **kw)
    got = ttree.build_prefix_tree(lex, tying, topo, trans, **kw)
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.max_out_degree == want.max_out_degree
    assert got.num_final_states == want.num_final_states
    assert [l.primary_orth for l in got.lemmas] == [l.primary_orth for l in want.lemmas]
    assert got.stats() == want.stats()
    assert (got.lookahead is not None) == lookahead


def test_no_lm_vocab_and_across_word():
    lex, topo, tying, _ = _setup(1)
    want = jtree.build_prefix_tree(lex, tying, topo)
    got = ttree.build_prefix_tree(lex, tying, topo)
    np.testing.assert_array_equal(got.we_word, want.we_word)
    assert ttree.BIG == 1.0e30 and ttree.WORD_NONE == jtree.WORD_NONE
    with pytest.raises(NotImplementedError):
        ttree.build_prefix_tree(lex, tying, topo, across_word=True)
    with pytest.raises(ValueError):
        ttree.build_prefix_tree(lex, tying, topo, skip_scope="utterance")
