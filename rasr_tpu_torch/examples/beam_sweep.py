"""Search-quality study: WER vs pruning settings (the classic beam curve).

The decoder's pruning (histogram cap ``max_hyps`` K, acoustic beam,
word-end limit R) trades search errors for speed exactly like the
reference's ``*-pruning`` parameters (ref: the beam/histogram pruning of
Search::WordConditionedTreeSearch / AdvancedTreeSearch). On an
acoustically CONFUSABLE synthetic corpus (close tone frequencies under
heavy noise) tight beams make search errors that wider beams recover,
reproducing the canonical WER-vs-beam tradeoff without any dataset.

Run: python -m rasr_tpu_torch.examples.beam_sweep [--device cpu]

The port's copy of ``examples/beam_sweep.py`` (the same draws, in the
same order), on the card unless ``--device cpu`` is given; ``NOISE`` in
the environment sets the noise level as there.
"""

import argparse
import math
import os
import time

import numpy as np

from ..align.aligner import BatchAligner, linear_segmentation
from ..align.graph import build_linear_graph
from ..corpus.lexicon import Lexicon, build_default_silence
from ..device import resolve
from ..lattice.evaluator import CorpusEvaluator
from ..models.gmm import MixtureSet
from ..models.hmm import HmmTopology, Tdp, TransitionModel
from ..models.lm.arpa import NgramLm
from ..models.lm.ngram import compile_ngram
from ..models.scorer import GmmFeatureScorer
from ..models.tying import MonophoneStateTying
from ..ops.frontend import FeatureFrontend, FrontendConfig
from ..search.decoder import BeamConfig, TreeDecoder
from ..search.tree import build_prefix_tree
from ..train.em import GmmAccumulator, accumulate, estimate

SR = 16000
PHONES = {f"p{i}": 500.0 + 300.0 * i for i in range(6)}  # separable tones
NOISE = float(os.environ.get("NOISE", "0.2"))  # vs tone amplitude 0.3
KS = (2, 4, 8, 32, 128)


def make_words(rng, n=20):
    names = list(PHONES)
    words, seen = {}, set()
    while len(words) < n:
        pair = tuple(rng.choice(names, 2))
        if pair not in seen:
            seen.add(pair)
            words[f"W{len(words):02d}"] = list(pair)
    return words


def synth(words, texts, rng):
    """Noisy tone audio for each word sequence."""
    out = []
    for ws in texts:
        audio = [np.zeros(1600, np.float32)]
        for w in ws:
            for p in words[w]:
                t = np.arange(int(0.2 * SR)) / SR
                audio.append(0.3 * np.sin(2 * np.pi * PHONES[p] * t))
            audio.append(np.zeros(1600, np.float32))
        a = np.concatenate(audio).astype(np.float32)
        out.append(a + NOISE * rng.normal(size=a.shape).astype(np.float32))
    return out


def pad_batch(waves):
    S = max(len(w) for w in waves)
    samples = np.zeros((len(waves), S), np.float32)
    lengths = np.zeros(len(waves), np.int64)
    for i, w in enumerate(waves):
        samples[i, : len(w)] = w
        lengths[i] = len(w)
    return samples, lengths


def run(device=None, say=print) -> dict:
    """Train the tone system, sweep K; returns the WER and the hypotheses
    per K (and asserts the curve's shape, as the reference does)."""
    device = resolve(device)
    rng = np.random.default_rng(11)
    words = make_words(rng)
    lex = Lexicon()
    build_default_silence(lex)
    for orth, phones in words.items():
        lex.add_lemma([orth], [(phones, 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    trans = TransitionModel(
        speech=Tdp(loop=0.7, forward=0.3, skip=math.inf, exit=0.5),
        silence=Tdp(loop=0.2, forward=0.8, skip=math.inf, exit=0.3),
    )
    fe = FeatureFrontend(FrontendConfig(num_cepstra=8, normalize="none"), device=device)

    names = list(words)
    train_texts = [list(rng.choice(names, 3)) for _ in range(48)]
    test_texts = [list(rng.choice(names, 3)) for _ in range(24)]
    lm = NgramLm.train_from_text(train_texts + [[w] for w in names], order=2)

    # -- GMM training (flat start + realignment, as the trainer tool does)
    feats, nf = fe(*pad_batch(synth(words, train_texts, rng)))
    nf = nf.cpu().numpy()
    graphs = [build_linear_graph(" ".join(ws), lex, tying, topo, trans) for ws in train_texts]
    M = tying.num_classes
    model = MixtureSet.single_density(np.zeros((M, feats.shape[-1]), np.float32),
                                      np.ones((M, feats.shape[-1]), np.float32))
    for it in range(5):
        acc = GmmAccumulator.zeros(*model.means.shape)
        if it == 0:
            labels = linear_segmentation(graphs, nf)
            pad = feats.shape[1] - labels.shape[1]
            if pad > 0:
                labels = np.pad(labels, ((0, 0), (0, pad)), constant_values=-1)
        else:
            als = BatchAligner(GmmFeatureScorer(model, device=device)).align(feats, graphs, nf)
            labels = np.full(feats.shape[:2], -1, np.int32)
            for i, al in enumerate(als):
                labels[i, : al.num_frames] = al.emission_ids
        accumulate(acc, model, feats, labels)
        model = estimate(acc, prev=None if it == 0 else model)

    # -- the sweep
    tables = compile_ngram(lm)
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    tfeats, tnf = fe(*pad_batch(synth(words, test_texts, rng)))
    emis = GmmFeatureScorer(model, device=device)(tfeats)
    audio_s = float(tnf.sum()) * 0.01

    say(f"{'K':>5} {'R':>4} | {'WER':>6} | audio-s/s (2nd run)")
    wers, hyps = {}, {}
    for K in KS:
        cfg = BeamConfig(max_hyps=K, word_end_limit=max(4, K // 4), root_hyps=min(8, K),
                         lm_scale=2.0)
        dec = TreeDecoder(tree, tables, cfg, device=device)
        dec.decode_scores(emis, tnf)  # warm-up, as the reference's compile run
        t0 = time.perf_counter()
        results = dec.decode_scores(emis, tnf)
        dt = time.perf_counter() - t0
        ev = CorpusEvaluator()
        for res, ws in zip(results, test_texts):
            ev.add("seg", " ".join(ws), res.orth)
        wers[K] = ev.report()["wer"]
        hyps[K] = [res.orth for res in results]
        say(f"{K:>5} {cfg.word_end_limit:>4} | {wers[K]:6.4f} | {audio_s / dt:8.1f}")

    # the canonical shape: tight beams cost accuracy badly, wide beams
    # plateau (a lucky tight beam can win an utterance: per-utterance
    # search errors are not monotone, so compare with slack)
    assert wers[128] <= wers[2] - 0.2, "wide beam must fix K=2's search errors"
    assert wers[128] <= min(wers.values()) + 0.05, "wide beam must be at the plateau"
    say(f"\nbeam curve OK: search errors vanish as K grows "
        f"(WER {wers[2]:.3f} @K=2 -> {wers[128]:.3f} @K=128)")
    return dict(wers=wers, hyps=hyps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="'cpu', or the card (the default)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
