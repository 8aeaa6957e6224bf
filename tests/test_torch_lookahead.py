"""The port's JAX-free copy of the bigram / trigram LM lookahead builder
(``rasr_tpu_torch.search.lookahead``) must equal ``rasr_tpu.search.lookahead``
array by array, on the within-word and the across-word network; its
device tables must equal the JAX decoder's, carried across by
``convert.bigram_tables_from_jax``; and both packages read each other's
lookahead images."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.hmm import HmmTopology, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.search import decoder as jdec
from rasr_tpu.search import lookahead as jla
from rasr_tpu.search.tree import build_prefix_tree as jax_build_prefix_tree
from rasr_tpu_torch import convert
from rasr_tpu_torch.models.lm import arpa as tarpa
from rasr_tpu_torch.search import lookahead as tla
from rasr_tpu_torch.search.decoder import BigramTables, bigram_to_device
from rasr_tpu_torch.search.tree import build_prefix_tree
from rasr_tpu_torch.synthetic import HashTying

FIELDS = ("sub_state", "state_class", "corr", "anchor_words", "arc_pair", "dpair")
TEXT = [["AB", "BA", "C"], ["ABC", "C", "AA"], ["BAB", "AB2", "AB"], ["C", "AB", "BA", "AA"],
        ["AB", "BA", "ABC"], ["AA", "C", "AB"]]


@pytest.fixture(scope="module")
def networks():
    """Both networks of one lexicon, each built by the JAX package and by
    the port, with an order-3 LM of each package (trigram contexts exist,
    so order-3 lookaheads get pair anchors)."""
    lex = Lexicon()
    build_default_silence(lex)
    for orth, pron in (("AB", "a b"), ("BA", "b a"), ("AA", "a a"), ("BAB", "b a b"),
                       ("ABC", "a b c"), ("C", "c"), ("AB2", "a b")):
        lex.add_lemma([orth], [(pron.split(), 0.1 * len(orth))])
    topo = HmmTopology(states_per_phone=3, silence_states=1)
    tying = HashTying(997, 2)
    jlm = NgramLm.train_from_text(TEXT, order=3)
    tlm = tarpa.NgramLm.train_from_text(TEXT, order=3)
    assert any(len(k) == 3 for k in jlm.ngrams)
    out = {}
    for across in (False, True):
        kw = dict(lm_vocab=jlm.vocab, across_word=across,
                  lm_unigrams={w: jlm.score((), w) for w in jlm.vocab.values()})
        out[across] = (jax_build_prefix_tree(lex, tying, topo, TransitionModel(), **kw),
                       build_prefix_tree(lex, tying, topo, TransitionModel(), **kw))
    return jlm, tlm, out


def _assert_same_lookahead(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.reentry == want.reentry


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("granularity", ["word-set", "first-phone"])
@pytest.mark.parametrize("across_word", [False, True])
def test_lookahead_equals_reference(networks, across_word, granularity, order):
    jlm, tlm, nets = networks
    jtree, ttree = nets[across_word]
    kw = dict(num_classes=6, granularity=granularity, order=order)
    want = jla.build_bigram_lookahead(jtree, jlm, **kw)
    got = tla.build_bigram_lookahead(ttree, tlm, **kw)
    if across_word and granularity == "first-phone":
        # first-phone subtrees exist only below the within-word tree's root
        assert want is None and got is None
        return
    _assert_same_lookahead(got, want)
    assert got.deep == (granularity == "word-set")
    assert np.any(got.corr != 0)
    if order == 3:
        assert got.anchor_words.shape[1] == 2  # last-two-word pair anchors


@pytest.mark.parametrize("case", ["smoothed", "general"])
def test_lookahead_other_builds_equal_reference(networks, case):
    """The softmin-smoothed word-set build, and the general (bitset) build
    that a network with a junction re-entry takes (``reentry``)."""
    jlm, tlm, nets = networks
    jtree, ttree = nets[False]
    kw = dict(num_classes=5)
    if case == "smoothed":
        kw["smooth"] = 0.5
    else:
        jtree, ttree = copy.deepcopy(jtree), copy.deepcopy(ttree)
        for t in (jtree, ttree):
            t.we_next = np.zeros_like(t.we_word)
            t.we_next[int(np.flatnonzero(t.we_word[:, 0] != -1)[0]), 0] = 2
    want = jla.build_bigram_lookahead(jtree, jlm, **kw)
    got = tla.build_bigram_lookahead(ttree, tlm, **kw)
    _assert_same_lookahead(got, want)
    assert got.reentry == (case == "general")


@pytest.mark.parametrize("across_word,granularity", [
    (False, "word-set"), (False, "first-phone"), (True, "word-set"),
])
def test_bigram_tables_convert_from_jax(networks, across_word, granularity):
    """``bigram_tables_from_jax`` of the JAX decoder's tables equals the
    port's ``bigram_to_device`` of its own lookahead, field by field."""
    jlm, tlm, nets = networks
    jtree, ttree = nets[across_word]
    want = jla.build_bigram_lookahead(jtree, jlm, num_classes=6, granularity=granularity)
    carried = convert.bigram_tables_from_jax(jdec.bigram_to_device(want, jtree), "cpu")
    native = bigram_to_device(tla.build_bigram_lookahead(ttree, tlm, num_classes=6,
                                                         granularity=granularity),
                              ttree, "cpu")
    assert native.deep == (granularity == "word-set")
    for f in dataclasses.fields(BigramTables):
        a, b = getattr(carried, f.name), getattr(native, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f.name)
        else:
            assert a == b, f.name


def test_lookahead_image_loads_across_packages(networks, tmp_path):
    jlm, tlm, nets = networks
    jtree, ttree = nets[True]
    want = jla.build_bigram_lookahead(jtree, jlm, num_classes=6, order=3)
    jla.save_bigram_lookahead(want, str(tmp_path / "jax.npz"))
    _assert_same_lookahead(tla.load_bigram_lookahead(str(tmp_path / "jax.npz")), want)
    tla.save_bigram_lookahead(tla.build_bigram_lookahead(ttree, tlm, num_classes=6, order=3),
                              str(tmp_path / "port.npz"))
    _assert_same_lookahead(jla.load_bigram_lookahead(str(tmp_path / "port.npz")), want)
