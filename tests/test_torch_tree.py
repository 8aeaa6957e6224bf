"""The port's JAX-free copy of the prefix-tree builders (within-word and
across-word) must equal ``rasr_tpu.search.tree`` field by field, and the
two packages must read each other's network images."""

import math

import numpy as np
import pytest

from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.tying import MonophoneStateTying
from rasr_tpu.search import tree as jtree
from rasr_tpu_torch.corpus import lexicon as tlexicon
from rasr_tpu_torch.models import hmm as thmm
from rasr_tpu_torch.models import tying as ttying
from rasr_tpu_torch.models.lm import arpa as tarpa
from rasr_tpu_torch.search import tree as ttree
from rasr_tpu_torch.synthetic import HashTying

ARRAYS = ("emission_class", "loop_cost", "arc_ptr", "arc_dst", "arc_cost", "we_word",
          "we_cost", "we_lemma", "lookahead", "we_next")


def _setup(states_per_phone, lexicon=Lexicon, silence=build_default_silence,
           topology=HmmTopology, tying=MonophoneStateTying, lm_class=NgramLm):
    lex = lexicon()
    silence(lex)
    for orth, pron in (("AB", "a b"), ("BA", "b a"), ("AA", "a a"), ("BAB", "b a b"),
                       ("ABC", "a b c"), ("C", "c"), ("AB2", "a b")):
        lex.add_lemma([orth], [(pron.split(), 0.25 * len(orth))])
    topo = topology(states_per_phone=states_per_phone, silence_states=1)
    lm = lm_class.train_from_text([["AB", "BA"], ["ABC", "C", "AA"], ["BAB", "AB2"]], order=2)
    return lex, topo, tying(lex, topo), lm


def _transitions(tdp, transition_model):
    return transition_model(
        speech=tdp(loop=1.0, forward=0.0, skip=2.0, exit=0.5),
        silence=tdp(loop=0.2, forward=0.5, skip=math.inf, exit=0.3),
    )


def _assert_same_tree(got, want, lookahead):
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


@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("skip_scope,states", [("word", 3), ("phone", 3), ("word", 1)])
def test_prefix_tree_equals_reference(lookahead, skip_scope, states):
    lex, topo, tying, lm = _setup(states)
    trans = _transitions(Tdp, TransitionModel)
    uni = {w: lm.score((), w) for w in lm.vocab.values()} if lookahead else None
    kw = dict(lm_vocab=lm.vocab, lm_unigrams=uni, skip_scope=skip_scope)
    want = jtree.build_prefix_tree(lex, tying, topo, trans, **kw)
    got = ttree.build_prefix_tree(lex, tying, topo, trans, **kw)
    _assert_same_tree(got, want, lookahead)


@pytest.mark.parametrize("states", [1, 3])
def test_prefix_tree_from_port_host_objects(states):
    """The port's tree over the port's own lexicon, topology, tying,
    transitions and LM equals the reference tree over the reference's."""
    lex, topo, tying, lm = _setup(states)
    want = jtree.build_prefix_tree(
        lex, tying, topo, _transitions(Tdp, TransitionModel), lm_vocab=lm.vocab,
        lm_unigrams={w: lm.score((), w) for w in lm.vocab.values()})
    lex, topo, tying, lm = _setup(states, tlexicon.Lexicon, tlexicon.build_default_silence,
                                  thmm.HmmTopology, ttying.MonophoneStateTying, tarpa.NgramLm)
    got = ttree.build_prefix_tree(
        lex, tying, topo, _transitions(thmm.Tdp, thmm.TransitionModel), lm_vocab=lm.vocab,
        lm_unigrams={w: lm.score((), w) for w in lm.vocab.values()})
    assert type(got.lemmas[0]) is tlexicon.Lemma
    _assert_same_tree(got, want, True)


def test_no_lm_vocab_and_across_word():
    lex, topo, tying, _ = _setup(1)
    want = jtree.build_prefix_tree(lex, tying, topo)
    got = ttree.build_prefix_tree(lex, tying, topo)
    np.testing.assert_array_equal(got.we_word, want.we_word)
    assert ttree.BIG == 1.0e30 and ttree.WORD_NONE == jtree.WORD_NONE
    # the across-word network (without an LM vocabulary): context roots,
    # word ends re-entering them, two final states
    want = jtree.build_prefix_tree(lex, tying, topo, across_word=True)
    got = ttree.build_prefix_tree(lex, tying, topo, across_word=True)
    _assert_same_tree(got, want, False)
    assert got.num_final_states == 2 and got.we_next is not None
    with pytest.raises(ValueError):
        ttree.build_prefix_tree(lex, tying, topo, skip_scope="utterance")


@pytest.mark.parametrize("ctx_groups", [0, 2])
@pytest.mark.parametrize("skip_scope", ["word", "phone"])
def test_across_word_network_equals_reference(skip_scope, ctx_groups):
    """Grouped context roots: a hashed triphone tying with every context
    distinct, and with contexts quantized to 2 groups (bench.py's
    ``BENCH_CTX_GROUPS``), which merges right-context copies into
    signature groups and stacks word-end slots."""
    lex, topo, _, lm = _setup(3)
    tying = HashTying(997, ctx_groups)
    kw = dict(lm_vocab=lm.vocab, lm_unigrams={w: lm.score((), w) for w in lm.vocab.values()},
              skip_scope=skip_scope, across_word=True)
    trans = _transitions(Tdp, TransitionModel)
    want = jtree.build_prefix_tree(lex, tying, topo, trans, **kw)
    got = ttree.build_prefix_tree(lex, tying, topo, trans, **kw)
    _assert_same_tree(got, want, True)
    assert got.num_final_states == 2
    assert int(got.we_next.max()) > 1  # re-entries at context roots
    roots = int(np.argmax(got.loop_cost < 1e29))
    assert roots > 2 and np.all(got.lookahead[:roots] == got.lookahead[0])


@pytest.mark.parametrize("across_word", [False, True])
def test_tree_image_loads_across_packages(tmp_path, across_word):
    """An image saved by the JAX package loads in the port, and one the
    port saved loads in the JAX package: the same arrays, lemmas rebound
    from the lexicon."""
    lex, topo, tying, lm = _setup(3)
    kw = dict(lm_vocab=lm.vocab, lm_unigrams={w: lm.score((), w) for w in lm.vocab.values()},
              across_word=across_word)
    trans = _transitions(Tdp, TransitionModel)
    want = jtree.build_prefix_tree(lex, tying, topo, trans, **kw)
    jtree.save_tree(want, str(tmp_path / "jax.npz"))
    got = ttree.load_tree(str(tmp_path / "jax.npz"), lex)
    _assert_same_tree(got, want, True)
    ttree.save_tree(ttree.build_prefix_tree(lex, tying, topo, trans, **kw),
                    str(tmp_path / "port.npz"))
    _assert_same_tree(jtree.load_tree(str(tmp_path / "port.npz"), lex), want, True)
    other = Lexicon()
    build_default_silence(other)
    other.add_lemma(["AB"], [(["a", "b"], 0.0)])
    with pytest.raises(ValueError):
        ttree.load_tree(str(tmp_path / "jax.npz"), other)
