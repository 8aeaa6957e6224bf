"""PyTorch port vs JAX: audio -> words through the whole decode slice.

One small synthetic setup (``rasr_tpu_torch.synthetic``, the benchmark's
generator at a few dozen words) drives the JAX pipeline (frontend ->
GMM scorer -> tree decoder) and two port pipelines: one whose state is
carried across from the JAX objects by ``convert.py``, and one built
natively by the port. All three must recognise the same words: under
decoder slice A's plain pruning, under bench.py's production pruning
(root select, deferred emission, root-arc cap) scaled down, and on the
across-word network with 4 context groups, bigram lookahead and compact
branch slots. A fourth pipeline puts a small conformer hybrid scorer
(float32, flax's parameters carried across) in front of the decoder.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rasr_tpu.models.gmm import MixtureSet as JaxMixtureSet
from rasr_tpu.models.nn import ConformerEncoderNet as JaxConformer
from rasr_tpu.models.nn import NnHybridScorer as JaxNnHybridScorer
from rasr_tpu.models.nn import StatePriors as JaxStatePriors
from rasr_tpu.models.hmm import HmmTopology, TransitionModel
from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.models.scorer import GmmFeatureScorer as JaxGmmScorer
from rasr_tpu.ops.frontend import FeatureFrontend as JaxFrontend
from rasr_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from rasr_tpu.search.decoder import BeamConfig as JaxBeamConfig
from rasr_tpu.search.decoder import TreeDecoder as JaxTreeDecoder
from rasr_tpu.search.decoder import bigram_to_device as jax_bigram_to_device
from rasr_tpu.search.lookahead import build_bigram_lookahead as jax_build_bigram_lookahead
from rasr_tpu.search.tree import build_prefix_tree as jax_build_prefix_tree
from rasr_tpu_torch import convert
from rasr_tpu_torch.models.scorer import GmmFeatureScorer
from rasr_tpu_torch.ops.frontend import FeatureFrontend, FrontendConfig
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder, _Step
from rasr_tpu_torch.synthetic import PATHS, PRODUCTION_BEAM, auto_branch_width, build_setup

BEAM = dict(max_hyps=64, word_end_limit=16, root_hyps=4, branch_hyps=16, lm_scale=10.0)
# the production beam's slice-B options at this size: R3 and the root-arc
# cap both bind (the network has ~60 root arcs)
BEAM_B = dict(BEAM, root_arc_limit=10, root_select=24, deferred_emission=True)
# the across-word path of chip_smoke.py scaled down: 4 context groups,
# word-set bigram lookahead, and compact slots that the 16 branch hyps'
# fans overflow (the grouped roots fan out to most of the vocabulary)
ACROSS = dict(PATHS["across-word"], branch_width=96)


def _jax_tree(s, across_word=False):
    """The JAX package's network of a ``build_setup`` result."""
    lm = s.lm
    unigrams = {wid: lm.ngrams[(wid,)][0] for wid in lm.vocab.values()}
    return jax_build_prefix_tree(
        s.lexicon, s.tying, HmmTopology(states_per_phone=3, silence_states=1),
        TransitionModel(), lm_vocab=lm.vocab, lm_unigrams=unigrams, skip_scope="phone",
        across_word=across_word,
    )


def _pipelines(BEAM, **knobs):
    s = build_setup(num_words=60, num_phones=12, num_classes=120, densities=4,
                    beam=BeamConfig(**BEAM), device="cpu", **knobs)
    lm = s.lm
    jtree = _jax_tree(s, knobs.get("across_word", False))
    bla = (None if s.bigram_la is None
           else jax_build_bigram_lookahead(jtree, lm, num_classes=64, order=2))
    beam = dataclasses.asdict(s.beam)  # the knobs' branch_width and lookahead update
    ms = s.mixtures
    jax_side = (
        JaxFrontend(JaxFrontendConfig(), splice_context=4, lda=s.lda),
        JaxGmmScorer(JaxMixtureSet(ms.means, ms.variances, ms.weights, ms.num_densities)),
        JaxTreeDecoder(jtree, jax_compile_ngram(lm), JaxBeamConfig(**beam), bigram_la=bla),
    )
    jfe, jsc, jdec = jax_side
    carried = (
        FeatureFrontend(FrontendConfig(**dataclasses.asdict(jfe.cfg)), splice_context=4,
                        lda=np.asarray(jfe.lda),
                        params=convert.frontend_params_from_jax(jfe.params, "cpu"), device="cpu"),
        GmmFeatureScorer(None, tensors=convert.scoring_tensors_from_jax(jsc.tensors, "cpu")),
        TreeDecoder(jtree, convert.ngram_tables_from_jax(jdec.lm, "cpu"), s.beam,
                    bigram_la=None if bla is None else convert.bigram_tables_from_jax(
                        jax_bigram_to_device(bla, jtree), "cpu"),
                    tables=convert.tree_tables_from_jax(jdec.tables, "cpu"), device="cpu"),
    )
    native = (s.frontend, s.scorer, s.decoder)
    return jax_side, carried, native


@pytest.fixture(scope="module")
def pipelines():
    return _pipelines(BEAM)


def _assert_audio_to_words_equal(pipelines):
    jax_side, *ports = pipelines
    rng = np.random.default_rng(7)
    lengths = np.array([16000, 11200, 7300])
    x = (rng.normal(size=(3, 16000)) * 0.1).astype(np.float32)
    jfe, jsc, jdec = jax_side
    jfeats, jn = jfe(x, lengths)
    want = jdec.decode_scores(jsc(jfeats, lengths=jn), np.asarray(jn))
    assert all(r.words for r in want)
    for fe, sc, dec in ports:
        feats, n = fe(torch.from_numpy(x), torch.from_numpy(lengths))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=2e-4, atol=2e-4)
        got = dec.results_from_device(dec.decode_scores_device(sc(feats, lengths=n), n))
        for a, b in zip(got, want):
            assert a.words == b.words
            assert a.word_ends == b.word_ends
            np.testing.assert_allclose(a.score, b.score, rtol=1e-4)


def test_audio_to_words_port_equals_jax(pipelines):
    _assert_audio_to_words_equal(pipelines)


def test_audio_to_words_slice_b_port_equals_jax(monkeypatch):
    pipes = _pipelines(BEAM_B)
    assert pipes[2][2].tables.root_degree > BEAM_B["root_arc_limit"]
    fanouts = []
    fanout = _Step._root_fanout

    def spy(self, *args):
        out = fanout(self, *args)
        fanouts.append(out[0])
        return out

    monkeypatch.setattr(_Step, "_root_fanout", spy)
    _assert_audio_to_words_equal(pipes)
    # the reference's root-select sort is unstable: its live pre-scores
    # must be tie-free for the two to pick the same survivors
    assert fanouts and fanouts[0].shape[1] > BEAM_B["root_select"]
    for p_root in fanouts:
        for row in p_root.numpy():
            live = row[row < 1e29]
            assert len(np.unique(live)) == len(live)


def test_audio_to_words_across_word_port_equals_jax():
    """chip_smoke.py's across-word path scaled down: the across-word
    network over a tying that quantizes contexts to 4 groups, word-set
    bigram lookahead ("arc" updates) and compact branch slots."""
    pipes = _pipelines(BEAM, **ACROSS)
    s_tree, decoder = pipes[2][2].tree, pipes[2][2]
    assert s_tree.num_final_states == 2 and s_tree.max_word_ends > 1
    assert decoder.bla is not None and decoder.bla.deep
    assert BEAM["branch_hyps"] * decoder.tables.branch_degree > ACROSS["branch_width"]
    _assert_audio_to_words_equal(pipes)


def test_audio_to_words_conformer_port_equals_jax():
    """Audio -> MFCC -> a conformer hybrid scorer (d=32, 2 blocks, float32,
    ragged lengths; flax's parameters in the port's network) -> the
    production pruning scaled down -> words."""
    widths = dict(d_model=32, num_blocks=2, num_heads=4, ff_mult=4, conv_kernel=5)
    s = build_setup(num_words=60, num_phones=12, num_classes=120, beam=BeamConfig(**BEAM_B),
                    device="cpu", scorer="conformer", nn_dtype="float32", conformer=widths)
    assert s.mixtures is None and s.scorer.num_classes == 120
    jnet = JaxConformer(num_classes=120, **widths)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 45), jnp.float32))["params"]
    s.scorer.model.load_state_dict(convert.nn_params_from_flax(s.scorer.model, params))
    priors = JaxStatePriors(s.scorer.log_priors.numpy())
    jax_side = (JaxFrontend(JaxFrontendConfig(), splice_context=4, lda=s.lda),
                JaxNnHybridScorer(jnet, params, priors, scale=10.0),
                JaxTreeDecoder(_jax_tree(s), jax_compile_ngram(s.lm), JaxBeamConfig(**BEAM_B)))
    _assert_audio_to_words_equal((jax_side, (s.frontend, s.scorer, s.decoder)))


def test_build_setup_applies_bench_branch_width_rule():
    """bench.py's auto rule (bench.py:218-223): the dense branch fan while
    Kb x the largest overflow degree fits 4096 - 3K, else compact slots."""
    kw = dict(num_words=60, num_phones=12, num_classes=120, densities=4)
    s = build_setup(**kw, device="cpu")
    assert s.beam == PRODUCTION_BEAM and s.decoder.cfg.root_select == 512
    deg = s.tree.arc_ptr[1:] - s.tree.arc_ptr[:-1]
    db = max(int((deg[1:] - 2).max()), 1)
    assert auto_branch_width(s.tree, PRODUCTION_BEAM) == 0
    # a budget of 254 slots, which 300 hypotheses' fans overflow
    wide = dataclasses.replace(PRODUCTION_BEAM, max_hyps=1400, branch_hyps=300)
    assert 300 * db > 256
    assert auto_branch_width(s.tree, wide) == 254
    s_wide = build_setup(**kw, beam=wide, device="cpu")
    assert s_wide.beam == dataclasses.replace(wide, branch_width=254)
    assert s_wide.decoder.cfg.branch_width == 254
