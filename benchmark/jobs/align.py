"""The acoustic model trainer's Viterbi pass: align, then accumulate.

Per batch, as the port's trainer chains it: the transcripts' linear graphs
(``align/graph.py::build_linear_graph``, on the host), ``FeatureFrontend``,
the model's scores, ``BatchAligner.align_scores`` and
``train/em.py::accumulate`` of the alignment's labels into one accumulator
for the window. The rate is the aligned and accumulated audio over the
window, which ends when the last batch's statistics are on the host. The
per-corpus re-estimation is left out. EM statistics are a GMM's: the
configuration's model (``benchmark/models/<scorer>.py``) has to give the
mixtures they accumulate into.

After the window a sample of the alignments, drawn from the seed and
holding a longest transcript, is held to the reference's best alignment of
the same graph (its reported score, and the score of its path), and the
statistics one batch drawn from the seed added to the accumulator are held
to the reference's statistics of the same frames under the same labels.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import spec, system, trace, traffic
from ..counts import Work
from ..counts import frontend as frontend_counts
from ..reference import align as ralign
from ..reference import decode as rdec
from ..reference import frontend as rfe
from ..reference.precision import QUANT

SPANS = ("graphs", "frontend", "scorer", "aligner", "accumulate")
WARMUP_INDEX = 1 << 30


def run(r) -> dict:
    from rasr_tpu_torch.align.aligner import BatchAligner
    from rasr_tpu_torch.align.graph import build_linear_graph
    from rasr_tpu_torch.train import em

    cfg, t, dev = r.cfg, r.traffic, r.device
    sr = cfg["sample_rate"]
    am = spec.model(cfg)
    if not hasattr(am, "mixtures"):
        raise ValueError(f"the align job accumulates GMM statistics, and the acoustic model "
                         f"{cfg['scorer']!r} has no mixtures (benchmark/models/"
                         f"{cfg['scorer']}.py has no mixtures())")
    d = system.draw(cfg, r.seed)
    s = system.build(cfg, d, dev, am.weights(cfg, r.seed, dev), decoder=False)
    lex, topo, trans, tying = system.port_lexicon(cfg, d)
    mixtures = am.mixtures(cfg, d)
    M, K, D = mixtures.means.shape
    aligner = BatchAligner(s.scorer)
    vocab_words = [w for w, _ in d.words]

    def chain(index, acc, spec=t, key="words"):
        x, lengths, n = traffic.audio_batch(spec, sr, r.seed, index, dev)
        orths = traffic.transcripts(spec, vocab_words, r.seed, index, key)
        with trace.span("graphs"):
            graphs = [build_linear_graph(" ".join(o), lex, tying, topo, trans) for o in orths]
        with trace.span("frontend"):
            feats, nf = s.frontend(x, lengths)
        with trace.span("scorer"):
            scores = s.scorer(feats)
        with trace.span("aligner"):
            als = aligner.align_scores(scores, graphs, nf)
        labels = np.full(tuple(feats.shape[:2]), -1, np.int32)
        for i, a in enumerate(als):
            labels[i, : a.num_frames] = a.emission_ids
        with trace.span("accumulate"):
            em.accumulate(acc, mixtures, feats, labels)
        return x, n, orths, als, labels

    warm = dict(t, min_s=t["warmup_s"], max_s=t["warmup_s"])
    chain(WARMUP_INDEX, em.GmmAccumulator.zeros(M, K, D), warm, "warmup_words")
    trace.sync()
    setup_s = time.time() - r.started

    rng = np.random.default_rng(traffic.sub_seed(r.seed, 7))
    stats_batch = int(rng.integers(0, 4))
    acc = em.GmmAccumulator.zeros(M, K, D)
    kept, samples, frames, before, after, labels_of_stats, longest = {}, [], [], None, None, None, None
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    trace.sync()
    t0 = time.perf_counter()
    i = 0
    while True:
        if i == stats_batch:
            before = (acc.count.copy(), acc.sum.copy(), acc.sumsq.copy())
        x, n, orths, als, labels = chain(i, acc)
        if i == stats_batch:
            after = (acc.count.copy(), acc.sum.copy(), acc.sumsq.copy())
            labels_of_stats = labels
        rows = [int(np.argmax([len(o) for o in orths]))]
        rows += [int(v) for v in rng.choice(len(orths), 1)]
        for row in rows:
            kept[(i, row)] = (orths[row], als[row])
        longest = longest or (i, rows[0])
        samples.append(n)
        frames.append([a.num_frames for a in als])
        i += 1
        el = time.perf_counter() - t0
        if el + el / i >= r.seconds and i > stats_batch:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    audio_s = float(sum(v.sum() for v in samples)) / sr
    utts = sum(len(v) for v in samples)
    print(f"[align] {i} batches, {utts} utterances, {audio_s:.1f} audio-s in {window_s:.2f} s: "
          f"{audio_s / window_s:.2f} audio-s/s; set-up {setup_s:.2f} s", file=sys.stderr)
    out = {"end_to_end": {"align_audio_s_per_s": audio_s / window_s, "setup_s": setup_s},
           "attempted": utts, "memory_peak_bytes": peak}
    window_work = Work()
    for n, fr in zip(samples, frames):
        window_work = window_work + frontend_counts.work(n, fr, cfg) + am.forward_work(fr, cfg)
    layer = {"window": {"align": (window_work, window_s)}}
    if r.trace:
        with trace.profiled() as prof:
            _, n, _, als, _ = chain(i, em.GmmAccumulator.zeros(M, K, D))
        layer["summary"] = trace.summarize(prof, SPANS)
        fr = [a.num_frames for a in als]
        layer["work"] = {"frontend": frontend_counts.work(n, fr, cfg),
                         "scorer": am.forward_work(fr, cfg)}
        layer["steps"] = {"aligner": max(fr)}
    out["layer"] = layer

    del s, aligner
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    delta = tuple(b - a for a, b in zip(before, after))
    out.update(check(r, d, kept, longest, stats_batch, labels_of_stats, delta))
    return out


def check(r, d, kept, longest, stats_batch, labels, delta) -> dict:
    cfg, t, dev = r.cfg, r.traffic, r.device
    sr = cfg["sample_rate"]
    am = spec.model(cfg)
    model = rdec.Model(cfg, d.words, d.vocab, d.ngrams)
    quant = QUANT[r.control] if r.control else None
    var_floor = cfg["gmm"]["var_floor"]
    limits = cfg["limits"]["align"]

    def reference(audio):
        rf = torch.from_numpy(rfe.features(audio.cpu().numpy(), d.lda, cfg)).to(dev)
        if quant is None:
            return rf, None
        pf = rfe.features_lowered(audio, d.lda, cfg, quant)
        return rf, pf

    # the alignments
    rng = np.random.default_rng(traffic.sub_seed(r.seed, 8))
    rest = sorted(k for k in kept if k != longest)
    picks = [longest] + [rest[j] for j in rng.choice(len(rest), min(
        t["check_utterances"] - 1, len(rest)), replace=False)]
    gap = 0.0
    failed = 0
    for b, row in picks:
        orth, al = kept[(b, row)]
        x, _, n = traffic.audio_batch(t, sr, r.seed, b, dev)
        rf, pf = reference(x[row, : n[row]])
        re = am.reference_scores(rf, d, None, cfg).cpu().numpy()
        g = ralign.chain(model, orth)
        ref_best, _ = ralign.best(*g, re)
        score, path = al.score, al.state_indices
        if quant is not None:  # the reference in a lower precision, in the program's place
            pe = am.reference_scores(pf, d, None, cfg, quant).double().cpu().numpy()
            score, path = ralign.best(*g, pe)
        elif not np.array_equal(np.asarray(al.emission_ids), g[0][path]):
            score = math.inf  # not this graph's path
        u = max(abs(score - ref_best), abs(ralign.path_cost(*g, re, path) - ref_best))
        u = u if math.isfinite(u) else math.inf
        print(f"[align] batch {b} row {row}: {len(path)} frames, {len(orth)} words, "
              f"{len(g[0])} states, score {score!r} - reference {ref_best!r}", file=sys.stderr)
        failed += int(limits["alignment_score_gap"] is None or u > limits["alignment_score_gap"])
        gap = max(gap, u)

    # the statistics of one batch
    x, _, n = traffic.audio_batch(t, sr, r.seed, stats_batch, dev)
    labels = torch.as_tensor(labels, device=dev)
    ref_feats, low_feats, lab = [], [], []
    for row in range(len(n)):
        rf, pf = reference(x[row, : n[row]])
        ref_feats.append(rf)
        low_feats.append(pf)
        lab.append(labels[row, : rf.shape[0]])
    lab = torch.cat(lab)
    ref = [v.cpu().numpy()
           for v in ralign.statistics(torch.cat(ref_feats), lab, d.acoustic, var_floor)]
    got = delta if quant is None else [v.cpu().numpy() for v in ralign.statistics(
        torch.cat(low_feats), lab, d.acoustic, var_floor)]
    stats_gap = max(float(np.abs(g_ - w).max() / np.abs(w).max()) for g_, w in zip(got, ref))
    failed += int(limits["stats_gap"] is None or stats_gap > limits["stats_gap"])
    print(f"[align] checked {len(picks)} alignments and the statistics of batch {stats_batch}",
          file=sys.stderr)
    return {"failed": failed, "check": {"alignment_score_gap": (gap, limits["alignment_score_gap"]),
                                        "stats_gap": (stats_gap, limits["stats_gap"])}}
