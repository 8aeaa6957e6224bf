#!/usr/bin/env python
"""Online (streaming) recognition demo: restart / feed blocks / current_best.

The reference's search API is online (Search::SearchAlgorithm: feed one
feature at a time, query the current best sentence mid-segment); the
port feeds BLOCKS of frames into a persistent beam on the card
(``search/streaming.StreamingDecoder``). This demo builds a tiny
tone-word system in-process, then receives audio block by block as a
serving frontend would:

  * after every block it prints the current best partial hypothesis
    (the reference's getCurrentBestSentence semantics), and
  * at the end it finalizes and asserts the streamed result is IDENTICAL
    to the offline whole-utterance decode (the streaming path is the same
    frame step, so exactness carries over).

Run:  python -m rasr_tpu_torch.examples.streaming_demo [--device cpu]

The port's copy of ``examples/streaming_demo.py``, on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from ..align.aligner import linear_segmentation
from ..align.graph import build_linear_graph
from ..corpus.lexicon import Lexicon, build_default_silence
from ..device import resolve
from ..models.gmm import MixtureSet
from ..models.hmm import HmmTopology, Tdp, TransitionModel
from ..models.lm.arpa import NgramLm
from ..models.lm.ngram import compile_ngram
from ..models.scorer import GmmFeatureScorer
from ..models.tying import MonophoneStateTying
from ..ops.frontend import FeatureFrontend, FrontendConfig
from ..search.decoder import BeamConfig, TreeDecoder
from ..search.streaming import StreamingDecoder
from ..search.tree import build_prefix_tree
from ..train.em import GmmAccumulator, accumulate, estimate

SR = 16000
TONES = {"a": 500.0, "b": 2000.0}
WORDS = {"AB": ["a", "b"], "BA": ["b", "a"]}
BLOCK = 32  # frames per feed (~0.32 s of audio)


def tone(sym: str, dur: float, rng) -> np.ndarray:
    t = np.arange(int(dur * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * TONES[sym] * t)
            + 0.01 * rng.normal(size=t.shape)).astype(np.float32)


def silence(dur: float, rng) -> np.ndarray:
    return (0.002 * rng.normal(size=int(dur * SR))).astype(np.float32)


def synthesize(words, rng) -> np.ndarray:
    parts = [silence(0.15, rng)]
    for w in words:
        for p in WORDS[w]:
            parts.append(tone(p, 0.25, rng))
        parts.append(silence(0.15, rng))
    return np.concatenate(parts)


def run(device=None, say=print) -> dict:
    """Build the system, stream the test utterance; returns the partial
    hypotheses after each block, the final and the offline result."""
    device = resolve(device)
    rng = np.random.default_rng(7)
    # ---- system build (library level; the toy recipe shows the tools)
    lex = Lexicon()
    build_default_silence(lex)
    for orth, phones in WORDS.items():
        lex.add_lemma([orth], [(phones, 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    trans = TransitionModel(
        speech=Tdp(loop=0.5, forward=0.0, skip=math.inf, exit=0.5),
        silence=Tdp(loop=0.1, forward=0.5, skip=math.inf, exit=0.3),
    )
    lm = NgramLm.train_from_text([["AB", "BA"], ["BA", "AB"], ["AB", "AB"], ["BA", "BA"]],
                                 order=2)
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)

    # streaming-friendly frontend: no segment-global statistics
    fe = FeatureFrontend(FrontendConfig(normalize="none"), device=device)

    # quick GMM from linearly segmented training audio (flat start + EM)
    train_texts = [["AB", "BA"], ["BA", "AB"], ["AB", "AB"], ["BA", "BA"]]
    waves = [synthesize(ws, rng) for ws in train_texts]
    S = max(len(w) for w in waves)
    samples = np.zeros((len(waves), S), np.float32)
    lengths = np.array([len(w) for w in waves])
    for i, w in enumerate(waves):
        samples[i, : len(w)] = w
    feats, nf = fe(samples, lengths)
    nf = nf.cpu().numpy()
    graphs = [build_linear_graph(" ".join(ws), lex, tying, topo, trans) for ws in train_texts]
    model = None
    labels = linear_segmentation(graphs, nf)
    pad = feats.shape[1] - labels.shape[1]
    if pad > 0:
        labels = np.pad(labels, ((0, 0), (0, pad)), constant_values=-1)
    D = feats.shape[-1]
    for _ in range(3):
        acc = GmmAccumulator.zeros(tying.num_classes, 1, D)
        accumulate(acc, model or MixtureSet.single_density(
            np.zeros((tying.num_classes, D), np.float32),
            np.ones((tying.num_classes, D), np.float32)), feats, labels)
        model = estimate(acc, prev=model)
    scorer = GmmFeatureScorer(model, device=device)
    decoder = TreeDecoder(tree, compile_ngram(lm),
                          BeamConfig(max_hyps=128, word_end_limit=16, lm_scale=2.0), device=device)

    # ---- the online part: blocks arrive, the beam persists on the device
    test_words = ["AB", "BA", "AB"]
    audio = synthesize(test_words, rng)
    feats, nf = fe(audio[None, :], np.array([len(audio)]))
    emis = scorer(feats)  # a serving stack would score per block
    T = int(nf[0])
    sd = StreamingDecoder(decoder).restart(batch_size=1)  # length unknown
    say(f"streaming {T} frames in {BLOCK}-frame blocks (reference: {' '.join(test_words)})")
    partials, t = [], 0
    while t < T:
        block = emis[:, t: t + BLOCK]
        sd.feed(block)
        t += block.shape[1]
        partials.append(sd.current_best()[0].orth)
        say(f"  t={t * 0.01:5.2f}s  partial: {partials[-1]!r}")
    final = sd.finalize()[0]
    say(f"final:   {final.orth!r}  (score {final.score:.2f})")
    offline = decoder.decode_scores(emis[:, :T], np.array([T], np.int32))[0]
    assert final.words == offline.words, (final.words, offline.words)
    assert abs(final.score - offline.score) < 1e-4
    assert final.words == test_words, (final.words, test_words)
    say("streaming == offline decode; hypothesis matches the reference")
    return dict(partials=partials, final=final, offline=offline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="'cpu', or the card (the default)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
