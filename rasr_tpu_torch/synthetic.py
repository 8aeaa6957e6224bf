"""The synthetic production-shape decode setup of ``bench.py``, on the port.

:func:`build_setup` rebuilds ``bench.py``'s ``build_setup`` with the same
seeds and the same order of random draws: a lexicon of random
pronunciations over ``num_phones`` phones, a hashed pseudo-CART tying to
``num_classes`` tied states, a random n-gram LM with unigram lookahead,
diagonal GMMs of ``densities`` densities each over ``feat_dim``-dim
features, and a random LDA from 9 spliced 16-dim MFCC frames. At the
defaults that is the benchmark's shape: 5k words, 40 phones, 2000 x 8 x
45 GMMs, LDA 144 -> 45, a bigram LM over the within-word network with
phone-scope skips. The decoder gets ``bench.py``'s production beam,
:data:`PRODUCTION_BEAM`; :data:`SLICE_A_BEAM` is the same beam without the
slice-B pruning (root select, deferred emission, root-arc cap).

Its keyword knobs are ``bench.py``'s environment knobs (``BENCH_LM_ORDER``,
``BENCH_SKIP_SCOPE``, ``BENCH_ACROSS``, ``BENCH_CTX_GROUPS``,
``BENCH_LA_ORDER``, ``BENCH_LA_CLASSES``, ``BENCH_LA_SMOOTH``,
``BENCH_LA_UPDATE``, ``BENCH_BRANCH_WIDTH``, ``BENCH_SCORER``,
``BENCH_NN_DTYPE``, ``BENCH_NET_CACHE``) with their defaults, so at the defaults the network,
LM and decode are the benchmark's headline ones. ``scorer="conformer"``
is bench.py's hybrid conformer (``bench.py:186-204``): d=512, 12 blocks,
8 heads, bf16 products, priors drawn where the GMMs would be; its weights
are the port's own draws from ``seed`` (``models.nn.init_params``, flax's
initializers), not JAX's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np

from .corpus.lexicon import Lexicon, build_default_silence
from .models.hmm import HmmTopology, TransitionModel
from .models.lm.arpa import NgramLm
from .models.tying import StateTying
from .device import resolve
from .models.gmm import MixtureSet
from .models.lm.ngram import compile_ngram
from .models.nn import ConformerEncoderNet, NnHybridScorer, StatePriors, init_params
from .models.scorer import FeatureScorer, GmmFeatureScorer
from .ops.frontend import FeatureFrontend, FrontendConfig
from .search.decoder import BeamConfig, TreeDecoder
from .search.lookahead import BigramLookahead, build_bigram_lookahead
from .search.tree import PrefixTree, build_prefix_tree, load_tree, save_tree


class HashTying(StateTying):
    """Pseudo-CART: a deterministic hash of (allophone, state) to
    ``num_classes`` tied classes (the compute shape of a CART tying).

    ``ctx_groups`` quantizes the left and right context phones into that
    many groups before hashing, as a realistic CART collapses most
    contexts; 0 keeps every context distinct (the across-word network's
    worst case)."""

    def __init__(self, n: int, ctx_groups: int = 0):
        self.num_classes = n
        self.g = ctx_groups

    def _ctx(self, p):
        return (1 + p % self.g) if (self.g and p) else p

    def classify(self, state):
        al = state.allophone
        left, right = self._ctx(al.left), self._ctx(al.right)
        h = (
            (al.center * 73856093) ^ (left * 19349663) ^ (right * 83492791)
            ^ (state.state * 2971215073)
        )
        return 1 + (h % (self.num_classes - 1))


#: bench.py's decoder config at its environment defaults (bench.py:224-275);
#: its auto ``branch_width`` rule gives 0 (the dense fan) on the headline
#: network
PRODUCTION_BEAM = BeamConfig(
    max_hyps=1024, beam=1e9, word_end_limit=64, root_hyps=16, branch_hyps=146,
    root_arc_limit=160, expansion_limit=0, root_select=512, deferred_emission=True,
    lm_scale=10.0,
)
#: the production beam without slice B: every root arc of the 16 root
#: hypotheses rides the main recombination, emission added per candidate
SLICE_A_BEAM = BeamConfig(
    max_hyps=1024, beam=1e9, word_end_limit=64, root_hyps=16, branch_hyps=146, lm_scale=10.0,
)


#: ``build_setup`` knobs of the two decode paths beyond the headline one
#: (``chip_smoke.py``, ``examples/profile_decode.py``): bench.py's
#: ``BENCH_ACROSS=1 BENCH_CTX_GROUPS=4 BENCH_LA_ORDER=2`` cell, and its
#: ``BENCH_LM_ORDER=4 BENCH_LA_ORDER=3 BENCH_SKIP_SCOPE=word
#: BENCH_LA_UPDATE=survivor`` cell; both take compact branch slots by the
#: auto rule
PATHS = {
    "across-word": dict(across_word=True, ctx_groups=4, la_order=2),
    "4-gram": dict(lm_order=4, la_order=3, skip_scope="word", lookahead_update="survivor"),
    # bench.py's BENCH_SCORER=conformer: the headline network and LM
    "conformer": dict(scorer="conformer"),
}

#: bench.py's conformer widths (``bench.py:192-195``; ff_mult and the conv
#: kernel at ConformerEncoderNet's defaults)
CONFORMER = dict(d_model=512, num_blocks=12, num_heads=8, ff_mult=4, conv_kernel=15)


def auto_branch_width(tree: PrefixTree, beam: BeamConfig) -> int:
    """bench.py's automatic ``branch_width`` (bench.py:218-223): 0 (the
    dense fan) while ``branch_hyps`` x the largest overflow degree fits the
    sort budget ``4096 - 3K``, else that budget in compact slots."""
    deg = tree.arc_ptr[1:] - tree.arc_ptr[:-1]
    db_est = int(max(int((deg[1:] - 2).max()), 1)) if deg.size > 1 else 1
    budget = max(4096 - 3 * beam.max_hyps, 256) - 2
    kb = beam.branch_hyps or beam.max_hyps
    return 0 if kb * db_est <= budget + 2 else budget


class Setup(NamedTuple):
    frontend: FeatureFrontend
    scorer: FeatureScorer
    decoder: TreeDecoder
    tree: PrefixTree
    lexicon: Lexicon
    lm: NgramLm
    tying: HashTying
    mixtures: Optional[MixtureSet]  # None under the conformer
    lda: np.ndarray
    beam: BeamConfig  # as the decoder runs it (branch_width resolved)
    bigram_la: Optional[BigramLookahead] = None


def build_setup(
    num_words: int = 5000,
    num_phones: int = 40,
    num_classes: int = 2000,
    densities: int = 8,
    feat_dim: int = 45,
    seed: int = 0,
    device=None,
    beam: BeamConfig = PRODUCTION_BEAM,
    lm_order: int = 2,
    skip_scope: str = "phone",
    across_word: bool = False,
    ctx_groups: int = 0,
    la_order: int = 1,
    la_classes: int = 64,
    la_smooth: float = 0.0,
    lookahead_update: str = "arc",
    branch_width: int = -1,
    scorer: str = "gmm",
    nn_dtype: str = "bfloat16",
    conformer: dict = CONFORMER,
    net_cache: str = "",
) -> Setup:
    """The benchmark setup. ``lm_order`` > 2 extends the bigrams to
    higher orders (``bench.py:116-126``); ``la_order`` >= 2 builds the
    word-set bigram lookahead (3: trigram pair anchors) with
    ``la_classes`` history classes and softmin ``la_smooth``; the decoder
    runs ``beam`` with its ``lookahead_update`` and its ``branch_width``
    replaced, -1 meaning bench.py's auto rule (:func:`auto_branch_width`).
    ``scorer`` is ``"gmm"`` (``densities`` per class) or ``"conformer"``
    (``ConformerEncoderNet(**conformer)`` computing in ``nn_dtype``, the
    hybrid scorer at scale 10). ``net_cache`` is bench.py's
    ``BENCH_NET_CACHE`` (``bench.py:131-141``): the network image to load
    when it exists, else to save after the build (the caller keys the
    path by configuration; a lexicon that does not match raises)."""
    device = resolve(device)
    if scorer not in ("gmm", "conformer"):
        raise ValueError(f"scorer must be 'gmm' or 'conformer', got {scorer!r}")
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
    tying = HashTying(num_classes, ctx_groups)

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
    for k in range(3, lm_order + 1):
        # higher orders extend existing (k-1)-grams, so prefix closure
        # holds; their contexts get backoff weights (they become LM states)
        prev = [g for g in ngrams if len(g) == k - 1]
        picks = rng.integers(0, len(prev), size=num_words * 8)
        for pi in picks:
            g = prev[int(pi)]
            w = int(rng.choice(ids))
            ngrams[g + (w,)] = (float(rng.uniform(1, 7)), 0.0)
            if g in ngrams and ngrams[g][1] == 0.0:
                ngrams[g] = (ngrams[g][0], float(rng.uniform(0.2, 1.5)))
    lm = NgramLm(lm_order, vocab, ngrams)
    unigrams = {wid: ngrams[(wid,)][0] for wid in vocab.values()}
    if net_cache and os.path.exists(net_cache):
        tree = load_tree(net_cache, lex)
    else:
        tree = build_prefix_tree(
            lex, tying, topology, TransitionModel(), lm_vocab=vocab,
            lm_unigrams=unigrams, across_word=across_word, skip_scope=skip_scope,
        )
        if net_cache:
            save_tree(tree, net_cache)
    bla = None
    if la_order >= 2:
        bla = build_bigram_lookahead(tree, lm, num_classes=la_classes,
                                     order=min(la_order, 3), smooth=la_smooth)
        if bla is None:
            raise ValueError("no bigram lookahead for this network")
    beam = dataclasses.replace(
        beam, lookahead_update=lookahead_update,
        branch_width=auto_branch_width(tree, beam) if branch_width < 0 else branch_width,
    )
    ms = None
    if scorer == "conformer":
        # the priors take the place of the GMM draws (bench.py's order)
        net = init_params(ConformerEncoderNet(num_classes, feat_dim, **conformer,
                                              compute_dtype=nn_dtype, device=device), seed)
        priors = StatePriors.from_counts(rng.uniform(1, 10, size=num_classes).astype(np.float32))
        acoustic = NnHybridScorer(net, None, priors, scale=10.0, device=device)
    else:
        ms = MixtureSet(
            means=rng.normal(size=(num_classes, densities, feat_dim)).astype(np.float32),
            variances=(0.5 + rng.uniform(size=(num_classes, densities, feat_dim)))
            .astype(np.float32),
            weights=np.full((num_classes, densities), 1.0 / densities, np.float32),
            num_densities=np.full(num_classes, densities, np.int32),
        )
        acoustic = GmmFeatureScorer(ms, scale=1.0, device=device)
    lda = (rng.normal(size=(16 * 9, feat_dim)) * 0.1).astype(np.float32)
    return Setup(
        frontend=FeatureFrontend(FrontendConfig(), splice_context=4, lda=lda, device=device),
        scorer=acoustic,
        decoder=TreeDecoder(tree, compile_ngram(lm), beam, bigram_la=bla, device=device),
        tree=tree, lexicon=lex, lm=lm, tying=tying, mixtures=ms, lda=lda, beam=beam,
        bigram_la=bla,
    )
