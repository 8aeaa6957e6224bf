"""The port's entry points run on the card unless the caller names a
device: called without ``device`` they take ``cuda_device()``, which
raises where no card is visible (as here), so nothing silently runs on
the CPU. With ``device="cpu"`` they build on the CPU, as the CPU tests
ask."""

import numpy as np
import pytest
import torch

from rasr_tpu_torch import convert
from rasr_tpu_torch.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu_torch.device import cuda_device
from rasr_tpu_torch.models.gmm import MixtureSet, make_scoring_tensors
from rasr_tpu_torch.models.hmm import HmmTopology, TransitionModel
from rasr_tpu_torch.models.lm.arpa import NgramLm
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.models.lm.rnn import LstmLm, RnnLm
from rasr_tpu_torch.models.nn import (
    BlstmEncoderNet, ConformerBlock, ConformerEncoderNet, ConvFrontendNet, FeedForwardNet,
    NnHybridScorer, StatePriors,
)
from rasr_tpu_torch.models.scorer import GmmFeatureScorer, PrecomputedScorer
from rasr_tpu_torch.models.tying import MonophoneStateTying
from rasr_tpu_torch.ops.frontend import FeatureFrontend, FrontendConfig, make_params
from rasr_tpu_torch.pipeline.battery import build_battery_task
from rasr_tpu_torch.search.decoder import BeamConfig
from rasr_tpu_torch.search.rnn_fusion import build_rnn_fusion
from rasr_tpu_torch.search.decoder import TreeDecoder, tree_to_device
from rasr_tpu_torch.search.streaming import StreamingDecoder
from rasr_tpu_torch.search.tree import build_prefix_tree
from rasr_tpu_torch.synthetic import build_setup


def _mixtures():
    rng = np.random.default_rng(0)
    return MixtureSet.single_density(rng.normal(size=(4, 3)).astype(np.float32),
                                     np.ones((4, 3), np.float32))


def _tree_and_lm():
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    lm = NgramLm.train_from_text([["AB", "AB"]], order=2)
    tree = build_prefix_tree(lex, MonophoneStateTying(lex, topo), topo, TransitionModel(),
                             lm_vocab=lm.vocab)
    return tree, compile_ngram(lm)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, list):
        return obj
    if isinstance(obj, torch.nn.Module):
        return list(obj.buffers()) + list(obj.parameters())
    return [v for v in vars(obj).values() if isinstance(v, torch.Tensor)]


def _streaming(**kw):
    """A stream restarted on the decoder's device: its carry."""
    sd = StreamingDecoder(TreeDecoder(*_tree_and_lm(), **kw)).restart(2)
    return [*sd._carry, sd._n_frames]


def _rnn_lm(**kw):
    return RnnLm(LstmLm(4, 3, 2), {"<s>": 0, "</s>": 1, "AB": 2, "BA": 3}, **kw)


def _fused_decoder(**kw):
    tree, lm = _tree_and_lm()
    fusion = build_rnn_fusion(_rnn_lm(device="cpu"), {"<s>": 0, "</s>": 1, "AB": 2},
                              device="cpu")
    return TreeDecoder(tree, lm, rnn_fusion=fusion, **kw).rnn


_BATTERY = []


def _battery_decoder(**kw):
    """A tiny battery task (built on the CPU once) and its decoder."""
    if not _BATTERY:
        _BATTERY.append(build_battery_task(num_words=20, num_phones=6, num_utts=1,
                                           n_train_sentences=30, lookahead_classes=4,
                                           device="cpu"))
    return _BATTERY[0].decoder(BeamConfig(max_hyps=8, word_end_limit=4), **kw).tables


SMALL_CONFORMER = dict(d_model=8, num_blocks=1, num_heads=2, ff_mult=2, conv_kernel=3)


ENTRY_POINTS = {
    "build_setup": lambda **kw: build_setup(num_words=10, num_phones=4, num_classes=12,
                                            densities=1, **kw).scorer,
    "TreeDecoder": lambda **kw: TreeDecoder(*_tree_and_lm(), **kw).tables,
    "FeatureFrontend": lambda **kw: FeatureFrontend(FrontendConfig(), **kw),
    "GmmFeatureScorer": lambda **kw: GmmFeatureScorer(_mixtures(), **kw).tensors,
    "make_scoring_tensors": lambda **kw: make_scoring_tensors(_mixtures(), **kw),
    "make_params": lambda **kw: make_params(FrontendConfig(), **kw),
    "tree_to_device": lambda **kw: tree_to_device(_tree_and_lm()[0], **kw),
    "PrecomputedScorer": lambda **kw: PrecomputedScorer(np.zeros((1, 2, 3), np.float32),
                                                        **kw)._scores,
    "scoring_tensors_from_jax": lambda **kw: convert.scoring_tensors_from_jax(
        make_scoring_tensors(_mixtures(), device="cpu"), **kw),
    "build_setup-conformer": lambda **kw: build_setup(
        num_words=10, num_phones=4, num_classes=12, scorer="conformer",
        conformer=SMALL_CONFORMER, **kw).scorer,
    "NnHybridScorer": lambda **kw: NnHybridScorer(
        FeedForwardNet(3, 4, hidden=(5,), device="cpu"), None,
        StatePriors.from_counts(np.ones(3)), **kw),
    "FeedForwardNet": lambda **kw: FeedForwardNet(3, 4, hidden=(5,), **kw),
    "ConvFrontendNet": lambda **kw: ConvFrontendNet(3, 4, channels=(2,), hidden=(5,), **kw),
    "BlstmEncoderNet": lambda **kw: BlstmEncoderNet(3, 4, hidden=(2,), **kw),
    "ConformerBlock": lambda **kw: ConformerBlock(8, num_heads=2, conv_kernel=3, **kw),
    "ConformerEncoderNet": lambda **kw: ConformerEncoderNet(3, 4, **SMALL_CONFORMER, **kw),
    "StreamingDecoder": _streaming,
    "RnnLm": lambda **kw: _rnn_lm(**kw).model,
    "RnnLm.train_from_text": lambda **kw: RnnLm.train_from_text(
        [["AB", "BA"]], embed_dim=3, hidden_dim=2, epochs=1, **kw).model,
    "build_rnn_fusion": lambda **kw: build_rnn_fusion(
        _rnn_lm(device="cpu"), {"<s>": 0, "</s>": 1, "AB": 2}, **kw),
    "TreeDecoder-rnn_fusion": _fused_decoder,
    "BatteryTask.decoder": _battery_decoder,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    build = ENTRY_POINTS[name]
    assert all(t.device.type == "cpu" for t in _tensors(build(device="cpu")))
    if torch.cuda.is_available():
        card = cuda_device()
        assert all(t.device == card for t in _tensors(build()))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device visible"):
            build()
