"""PyTorch port vs JAX: audio -> words through the whole decode slice.

One small synthetic setup (``rasr_tpu_torch.synthetic``, the benchmark's
generator at a few dozen words) drives the JAX pipeline (frontend ->
GMM scorer -> tree decoder) and two port pipelines: one whose state is
carried across from the JAX objects by ``convert.py``, and one built
natively by the port. All three must recognise the same words.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rasr_tpu.models.gmm import MixtureSet as JaxMixtureSet
from rasr_tpu.models.hmm import HmmTopology, TransitionModel
from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.models.scorer import GmmFeatureScorer as JaxGmmScorer
from rasr_tpu.ops.frontend import FeatureFrontend as JaxFrontend
from rasr_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from rasr_tpu.search.decoder import BeamConfig as JaxBeamConfig
from rasr_tpu.search.decoder import TreeDecoder as JaxTreeDecoder
from rasr_tpu.search.tree import build_prefix_tree as jax_build_prefix_tree
from rasr_tpu_torch import convert
from rasr_tpu_torch.models.scorer import GmmFeatureScorer
from rasr_tpu_torch.ops.frontend import FeatureFrontend, FrontendConfig
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu_torch.synthetic import build_setup

BEAM = dict(max_hyps=64, word_end_limit=16, root_hyps=4, branch_hyps=16, lm_scale=10.0)


@pytest.fixture(scope="module")
def pipelines():
    s = build_setup(num_words=60, num_phones=12, num_classes=120, densities=4,
                    beam=BeamConfig(**BEAM))
    lm = s.lm
    unigrams = {wid: lm.ngrams[(wid,)][0] for wid in lm.vocab.values()}
    jtree = jax_build_prefix_tree(
        s.lexicon, s.tying, HmmTopology(states_per_phone=3, silence_states=1),
        TransitionModel(), lm_vocab=lm.vocab, lm_unigrams=unigrams, skip_scope="phone",
    )
    ms = s.mixtures
    jax_side = (
        JaxFrontend(JaxFrontendConfig(), splice_context=4, lda=s.lda),
        JaxGmmScorer(JaxMixtureSet(ms.means, ms.variances, ms.weights, ms.num_densities)),
        JaxTreeDecoder(jtree, jax_compile_ngram(lm), JaxBeamConfig(**BEAM)),
    )
    jfe, jsc, jdec = jax_side
    carried = (
        FeatureFrontend(FrontendConfig(**dataclasses.asdict(jfe.cfg)), splice_context=4,
                        lda=np.asarray(jfe.lda),
                        params=convert.frontend_params_from_jax(jfe.params)),
        GmmFeatureScorer(None, tensors=convert.scoring_tensors_from_jax(jsc.tensors)),
        TreeDecoder(jtree, convert.ngram_tables_from_jax(jdec.lm), BeamConfig(**BEAM),
                    tables=convert.tree_tables_from_jax(jdec.tables)),
    )
    native = (s.frontend, s.scorer, s.decoder)
    return jax_side, carried, native


def test_audio_to_words_port_equals_jax(pipelines):
    jax_side, carried, native = pipelines
    rng = np.random.default_rng(7)
    lengths = np.array([16000, 11200, 7300])
    x = (rng.normal(size=(3, 16000)) * 0.1).astype(np.float32)
    jfe, jsc, jdec = jax_side
    jfeats, jn = jfe(x, lengths)
    want = jdec.decode_scores(jsc(jfeats), np.asarray(jn))
    assert all(r.words for r in want)
    for fe, sc, dec in (carried, native):
        feats, n = fe(torch.from_numpy(x), torch.from_numpy(lengths))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=2e-4, atol=2e-4)
        got = dec.results_from_device(dec.decode_scores_device(sc(feats), n))
        for a, b in zip(got, want):
            assert a.words == b.words
            assert a.word_ends == b.word_ends
            np.testing.assert_allclose(a.score, b.score, rtol=1e-4)
