"""The reference's randomized decoder oracle, run on the PyTorch port.

``tests/test_decoder_fuzz.py`` draws random systems (lexica of 2-3 words
over 2-3 phones, 1-3 states per phone, finite skips half the time, bigram
LMs from random text, a word-set lookahead half the time) and beam
variants that keep the search exact (``deferred_emission``,
``force_unpacked_keys``, covering ``branch_width`` and ``root_select``,
``word_end_rank_lm``, the correction scale). The same ten seeds make the
same draws here; the port's ``TreeDecoder`` over the port's tree, LM
tables and lookahead must reach the brute-force optimum (score within
1e-4 relative + 1e-3, any word sequence at the optimum) and the JAX
decoder's best score within 1e-5 relative.
"""

import math

import numpy as np
import pytest

from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.models.tying import MonophoneStateTying
from rasr_tpu.search import decoder as jdec
from rasr_tpu.search.lookahead import build_bigram_lookahead as jax_build_bigram_lookahead
from rasr_tpu.search.tree import build_prefix_tree as jax_build_prefix_tree
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu_torch.search.lookahead import build_bigram_lookahead
from rasr_tpu_torch.search.tree import build_prefix_tree
from tests.test_decoder_fuzz import _oracle

JAX_RTOL = 1e-5


def _draw(seed):
    """tests/test_decoder_fuzz.py's draws, in its order: the system, the
    emissions, the beam variant and the lookahead's parameters."""
    rng = np.random.default_rng(seed)
    phones = ["p", "q", "r"][: int(rng.integers(2, 4))]
    lex = Lexicon()
    build_default_silence(lex)
    n_words = int(rng.integers(2, 4))
    orths = []
    for i in range(n_words):
        length = int(rng.integers(1, 3))
        pron = [phones[int(rng.integers(len(phones)))] for _ in range(length)]
        orth = f"W{i}_" + "".join(pron).upper()
        lex.add_lemma([orth], [(pron, float(rng.uniform(0, 0.5)))])
        orths.append(orth)
    spp = int(rng.integers(1, 4))
    topo = HmmTopology(states_per_phone=spp, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    finite_skip = bool(rng.integers(2))
    trans = TransitionModel(
        speech=Tdp(
            loop=float(rng.uniform(0.1, 1.5)),
            forward=float(rng.uniform(0.0, 0.5)),
            skip=float(rng.uniform(0.5, 3.0)) if finite_skip else math.inf,
            exit=float(rng.uniform(0.0, 1.0)),
        ),
        silence=Tdp(
            loop=float(rng.uniform(0.1, 0.5)),
            forward=float(rng.uniform(0.0, 0.8)),
            skip=math.inf,
            exit=float(rng.uniform(0.0, 0.5)),
        ),
    )
    sents = [
        [orths[int(rng.integers(n_words))] for _ in range(int(rng.integers(1, 4)))]
        for _ in range(6)
    ]
    lm = NgramLm.train_from_text(sents, order=2)
    M = tying.num_classes
    T = int(rng.integers(5, 8))
    lm_scale = float(rng.uniform(0.3, 1.5))
    emis = rng.uniform(0.0, 6.0, size=(1, T, M)).astype(np.float32)
    variant = dict(
        deferred_emission=bool(rng.integers(2)),
        force_unpacked_keys=bool(rng.integers(2)),
        branch_width=int(rng.integers(2)) * 2048,
        word_end_rank_lm=bool(rng.integers(2)),
        root_select=int(rng.integers(2)) * 4096,
        lookahead_corr_scale=float(rng.choice([1.0, 0.5])),
    )
    la = None
    if rng.integers(2):
        la = dict(num_classes=int(rng.integers(2, 8)), order=int(rng.integers(2, 4)),
                  smooth=float(rng.choice([0.0, 1.0])))
    return lex, topo, tying, trans, lm, T, lm_scale, emis, variant, la


@pytest.mark.parametrize("seed", [11, 22, 33, 44, 55, 66, 77, 88, 101, 109])
def test_port_decoder_fuzz_exact(seed):
    lex, topo, tying, trans, lm, T, lm_scale, emis, variant, la = _draw(seed)
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    jtree = jax_build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    cfg = dict(max_hyps=512, beam=1e9, word_end_limit=128, root_hyps=512,
               lm_scale=lm_scale, **variant)
    port = TreeDecoder(tree, compile_ngram(lm), BeamConfig(**cfg),
                       bigram_la=None if la is None else build_bigram_lookahead(tree, lm, **la),
                       device="cpu")
    ref = jdec.TreeDecoder(
        jtree, jax_compile_ngram(lm), jdec.BeamConfig(**cfg),
        bigram_la=None if la is None else jax_build_bigram_lookahead(jtree, lm, **la))
    (res,) = port.decode_scores(emis, np.array([T]))
    (want,) = ref.decode_scores(emis, np.array([T]))
    oracle_score, oracle_seq, oracle_totals = _oracle(
        lex, topo, tying, trans, lm, emis, T, lm_scale, max_tokens=T)
    got = [lemma.primary_orth for lemma in res.lemmas]
    np.testing.assert_allclose(res.score, oracle_score, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(res.score, want.score, rtol=JAX_RTOL)
    # any optimal sequence: the decoders' tie order is not the oracle's
    got_cost = oracle_totals.get(tuple(got), np.inf)
    assert (
        got == list(oracle_seq)
        or got_cost <= oracle_score + max(1e-3, 1e-4 * abs(oracle_score))
    ), (got, oracle_seq, got_cost, oracle_score, variant, seed)
