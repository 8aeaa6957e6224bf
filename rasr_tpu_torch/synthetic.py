"""The synthetic production-shape decode setup of ``bench.py``, on the port.

:func:`build_setup` rebuilds ``bench.py``'s ``build_setup`` with the same
seeds and the same order of random draws: a lexicon of random
pronunciations over ``num_phones`` phones, a hashed pseudo-CART tying to
``num_classes`` tied states, a random bigram LM with unigram lookahead,
diagonal GMMs of ``densities`` densities each over ``feat_dim``-dim
features, and a random LDA from 9 spliced 16-dim MFCC frames. At the
defaults that is the benchmark's shape: 5k words, 40 phones, 2000 x 8 x
45 GMMs, LDA 144 -> 45. The decoder gets decoder slice A's beam
(K=1024, R=64, 16 root hypotheses, 146 branch hypotheses, lm_scale 10).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .host import (
    HmmTopology, Lexicon, NgramLm, StateTying, TransitionModel, build_default_silence,
)
from .models.gmm import MixtureSet
from .models.lm.ngram import compile_ngram
from .models.scorer import GmmFeatureScorer
from .ops.frontend import FeatureFrontend, FrontendConfig
from .search.decoder import BeamConfig, TreeDecoder
from .search.tree import PrefixTree, build_prefix_tree


class HashTying(StateTying):
    """Pseudo-CART: a deterministic hash of (allophone, state) to
    ``num_classes`` tied classes (the compute shape of a CART tying)."""

    def __init__(self, n: int):
        self.num_classes = n

    def classify(self, state):
        al = state.allophone
        h = (
            (al.center * 73856093) ^ (al.left * 19349663) ^ (al.right * 83492791)
            ^ (state.state * 2971215073)
        )
        return 1 + (h % (self.num_classes - 1))


class Setup(NamedTuple):
    frontend: FeatureFrontend
    scorer: GmmFeatureScorer
    decoder: TreeDecoder
    tree: PrefixTree
    lexicon: Lexicon
    lm: NgramLm
    tying: HashTying
    mixtures: MixtureSet
    lda: np.ndarray
    beam: BeamConfig


def build_setup(
    num_words: int = 5000,
    num_phones: int = 40,
    num_classes: int = 2000,
    densities: int = 8,
    feat_dim: int = 45,
    seed: int = 0,
    device="cpu",
    beam: BeamConfig = BeamConfig(
        max_hyps=1024, beam=1e9, word_end_limit=64, root_hyps=16,
        branch_hyps=146, lm_scale=10.0,
    ),
) -> Setup:
    rng = np.random.default_rng(seed)
    lex = Lexicon()
    build_default_silence(lex)
    phones = [f"p{i}" for i in range(num_phones)]
    for p in phones:
        lex.phonemes.add(p)
    seen = set()
    for w in range(num_words):
        length = int(rng.integers(2, 8))
        pron = tuple(rng.choice(phones, size=length))
        if pron in seen:
            continue
        seen.add(pron)
        lex.add_lemma([f"w{w}"], [(list(pron), 0.0)])
    topology = HmmTopology(states_per_phone=3, silence_states=1)
    tying = HashTying(num_classes)

    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2}
    for lemma in lex.lemmata:
        if lemma.special:
            continue
        vocab.setdefault(lemma.primary_orth, len(vocab))
    ngrams = {}
    for w, i in vocab.items():
        ngrams[(i,)] = (float(rng.uniform(5, 12)), float(rng.uniform(0.2, 2.0)))
    ids = np.asarray(list(vocab.values()))
    for _ in range(num_words * 12):
        a, b = rng.choice(ids), rng.choice(ids)
        ngrams[(int(a), int(b))] = (float(rng.uniform(2, 9)), 0.0)
    lm = NgramLm(2, vocab, ngrams)
    unigrams = {wid: ngrams[(wid,)][0] for wid in vocab.values()}
    tree = build_prefix_tree(
        lex, tying, topology, TransitionModel(), lm_vocab=vocab,
        lm_unigrams=unigrams, skip_scope="phone",
    )
    ms = MixtureSet(
        means=rng.normal(size=(num_classes, densities, feat_dim)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(num_classes, densities, feat_dim))).astype(np.float32),
        weights=np.full((num_classes, densities), 1.0 / densities, np.float32),
        num_densities=np.full(num_classes, densities, np.int32),
    )
    lda = (rng.normal(size=(16 * 9, feat_dim)) * 0.1).astype(np.float32)
    return Setup(
        frontend=FeatureFrontend(FrontendConfig(), splice_context=4, lda=lda, device=device),
        scorer=GmmFeatureScorer(ms, scale=1.0, device=device),
        decoder=TreeDecoder(tree, compile_ngram(lm), beam, device=device),
        tree=tree, lexicon=lex, lm=lm, tying=tying, mixtures=ms, lda=lda, beam=beam,
    )
