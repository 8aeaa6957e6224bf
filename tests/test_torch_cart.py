"""PyTorch port vs JAX: CART state tying (``models/cart.py``).

The port's copy is byte-identical to the reference's
(``tests/test_torch_config.py`` holds that); here both packages grow a
tree from the same examples and must write the same JSON, classify every
allophone state of a lexicon to the same class through
``CartStateTying``, and build the same prefix tree over that tying
(exact: the same host code over float64 statistics). A tree trained by
either package loads in the other.
"""

import json

import numpy as np
import pytest

from rasr_tpu.corpus import lexicon as jlexicon
from rasr_tpu.models import allophone as jallo
from rasr_tpu.models import cart as jcart
from rasr_tpu.models import hmm as jhmm
from rasr_tpu.models import tying as jtying
from rasr_tpu.models.lm import arpa as jarpa
from rasr_tpu.search import tree as jtree
from rasr_tpu_torch.corpus import lexicon as tlexicon
from rasr_tpu_torch.models import allophone as tallo
from rasr_tpu_torch.models import cart as tcart
from rasr_tpu_torch.models import hmm as thmm
from rasr_tpu_torch.models import tying as ttying
from rasr_tpu_torch.models.lm import arpa as tarpa
from rasr_tpu_torch.search import tree as ttree

PKGS = {
    "torch": (tlexicon, tallo, tcart, thmm, ttying, tarpa, ttree),
    "jax": (jlexicon, jallo, jcart, jhmm, jtying, jarpa, jtree),
}
WORDS = (("AB", "a b"), ("BA", "b a"), ("ABC", "a b c"), ("CAB", "c a b"), ("BB", "b b"),
         ("CA", "c a"), ("ACB", "a c b"), ("C", "c"))


def _lexicon(pkg):
    lexicon = PKGS[pkg][0]
    lex = lexicon.Lexicon()
    lexicon.build_default_silence(lex)
    for orth, pron in WORDS:
        lex.add_lemma([orth], [(pron.split(), 0.0)])
    return lex


def _states(pkg, lex, topo):
    alpha = PKGS[pkg][1].AllophoneAlphabet(lex, max_states=3)
    out = []
    for lemma in lex.words_with_pronunciations():
        for pron in lemma.pronunciations:
            out += alpha.phone_sequence_states(pron.phonemes, topo)
            for left in range(len(lex.phonemes) + 1):
                out += alpha.phone_states(pron.phonemes[0], left, pron.phonemes[-1], topo, 1)
    return out


def _examples(pkg, lex, seed=0, dim=5):
    """Sufficient statistics of every allophone state key of the lexicon
    (drawn per key from one seed, so both packages see the same numbers)."""
    cart, hmm = PKGS[pkg][2], PKGS[pkg][3]
    topo = hmm.HmmTopology(states_per_phone=3, silence_states=1)
    keys = sorted({(s.allophone.left, s.allophone.center, s.allophone.right, s.state)
                   for s in _states(pkg, lex, topo)})
    rng = np.random.default_rng(seed)
    ex = cart.CartExamples(dim)
    for key in keys:
        n = int(rng.integers(3, 12))
        frames = rng.normal(loc=key[1] + 0.3 * key[0] - 0.2 * key[2] + key[3], size=(n, dim))
        ex.add_frames([key] * n, frames)
    return ex, topo


@pytest.mark.parametrize("max_leaves", [4, 12, 40])
def test_cart_train_writes_the_same_json(max_leaves, tmp_path):
    trees = {}
    for pkg in PKGS:
        lex = _lexicon(pkg)
        ex, _ = _examples(pkg, lex)
        cart = PKGS[pkg][2]
        tree = cart.CartTree.train(ex, cart.default_questions(lex), max_leaves=max_leaves)
        tree.save(str(tmp_path / f"{pkg}.json"))
        trees[pkg] = json.loads((tmp_path / f"{pkg}.json").read_text())
    assert trees["torch"] == trees["jax"]
    assert trees["torch"]["num_classes"] == max_leaves


def test_cart_tying_and_prefix_tree_equal(tmp_path):
    """A JAX-trained tree loaded by the port classifies every allophone
    state as JAX's ``CartStateTying`` does, and the prefix trees built
    over the two tyings are equal."""
    lex = _lexicon("jax")
    ex, topo = _examples("jax", lex)
    tree = jcart.CartTree.train(ex, jcart.default_questions(lex), max_leaves=15)
    path = str(tmp_path / "cart.json")
    tree.save(path)
    built = {}
    for pkg in PKGS:
        lexicon, _, cart, hmm, tying, arpa, treemod = PKGS[pkg]
        lex_p = _lexicon(pkg)
        topo_p = hmm.HmmTopology(states_per_phone=3, silence_states=1)
        ty = tying.CartStateTying(cart.CartTree.load(path), lex_p)
        classes = [ty.classify(s) for s in _states(pkg, lex_p, topo_p)]
        lm = arpa.NgramLm.train_from_text([w.split() for w in ("AB BA", "ABC C CA", "BB CAB")],
                                          order=2)
        net = treemod.build_prefix_tree(
            lex_p, ty, topo_p, hmm.TransitionModel(), lm_vocab=lm.vocab,
            lm_unigrams={w: lm.score((), w) for w in lm.vocab.values()}, skip_scope="phone")
        built[pkg] = (ty.num_classes, classes, net)
    assert built["torch"][:2] == built["jax"][:2]
    assert len(set(built["torch"][1])) > 5
    got, want = built["torch"][2], built["jax"][2]
    for name in ("emission_class", "loop_cost", "arc_ptr", "arc_dst", "arc_cost", "we_word",
                 "we_cost", "we_lemma", "lookahead"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.stats() == want.stats()


def test_cart_train_with_separate_silence_class():
    """``separate`` pre-assigns key groups (the forced silence class)."""
    out = []
    for pkg in PKGS:
        lex = _lexicon(pkg)
        ex, _ = _examples(pkg, lex, seed=1)
        cart = PKGS[pkg][2]
        sil = [k for k in ex.stats if k[1] == lex.silence.pronunciations[0].phonemes[0]]
        tree = cart.CartTree.train(ex, cart.default_questions(lex), max_leaves=10,
                                   separate={0: sil})
        out.append((tree.to_dict(), [tree.classify_key(k) for k in sorted(ex.stats)]))
    assert out[0] == out[1]
    assert all(c == 0 for k, c in zip(sorted(ex.stats), out[0][1]) if k in sil)
