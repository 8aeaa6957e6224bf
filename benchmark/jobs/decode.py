"""Batch decoding: audio -> features -> emission scores -> beam search -> words.

The window drives the port's batch-decode entry in the order its
``OfflineRecognizer`` and ``bench.py`` call it: ``FeatureFrontend``, the
configuration's model's scorer (``benchmark/models/<scorer>.py``, called
as ``score(feats, lengths)``),
``TreeDecoder.decode_scores_device`` and ``results_from_device``, with
batches dispatched two deep: batch n + 1 is dispatched before batch n's
results are read. The window ends at the last batch's read; its rate is
the real (unpadded) audio of every batch it read over its length.

After the window a sample of the decoded utterances, drawn from the seed
and holding a longest one, is held to the plain reference: the features
and the emission scores against the reference's, and the decode's score
against the best path over the decoder's own emission scores, found with
no beam (``reference/search.py``), and against the best score of its own
words and word ends (``reference/decode.py``). The beam may lose to
pruning, never gain; a wrong word, word end or score shows in one of the
two. The configuration's limits name the numbers compared; the others
are printed.
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
from ..reference import decode as rdec
from ..reference import frontend as rfe
from ..reference import search as rsearch
from ..reference.precision import QUANT, bf16_round

SPANS = ("frontend", "scorer", "decoder", "results")
#: a batch index no window reaches: the warm-up batch's data
WARMUP_INDEX = 1 << 30


def run(r) -> dict:
    """One run of a decode cell."""
    cfg, t, dev = r.cfg, r.traffic, r.device
    sr = cfg["sample_rate"]
    am = spec.model(cfg)
    d = system.draw(cfg, r.seed)
    weights = am.weights(cfg, r.seed, dev)
    s = system.build(cfg, d, dev, weights)

    def dispatch(x, lengths):
        with trace.span("frontend"):
            feats, nf = s.frontend(x, lengths)
        with trace.span("scorer"):
            em = s.scorer(feats, lengths=nf)
        with trace.span("decoder"):
            handle = s.decoder.decode_scores_device(em, nf)
        return feats, em, handle

    def read(handle):
        with trace.span("results"):
            return s.decoder.results_from_device(handle)

    # warm-up: a short batch through every stage, then the first batch's
    # (longest) shapes through the frontend and the scorer
    warm = dict(t, min_s=t["warmup_s"], max_s=t["warmup_s"])
    read(dispatch(*traffic.audio_batch(warm, sr, r.seed, WARMUP_INDEX, dev)[:2])[2])
    x, lengths, _ = traffic.audio_batch(t, sr, r.seed, 0, dev)
    feats, nf = s.frontend(x, lengths)
    s.scorer(feats, lengths=nf)
    del x, lengths, feats, nf
    trace.sync()
    setup_s = time.time() - r.started

    pick_rng = np.random.default_rng(traffic.sub_seed(r.seed, 4))
    kept, results, frames, samples, longest = {}, {}, [], [], None
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    trace.sync()
    t0 = time.perf_counter()
    prev, i, marks = None, 0, []
    while True:
        x, lengths, n = traffic.audio_batch(t, sr, r.seed, i, dev)
        feats, em, handle = dispatch(x, lengths)
        rows = [int(np.argmax(n))] + [int(v) for v in pick_rng.choice(
            np.delete(np.arange(len(n)), int(np.argmax(n))), t["sample_per_batch"] - 1,
            replace=False)]
        for row in rows:
            kept[(i, row)] = (x[row, :n[row]].clone(), feats[row].clone(), em[row].clone())
        longest = longest or (i, rows[0])
        if prev is not None:
            results[prev[0]] = read(prev[1])
        prev = (i, handle)
        samples.append(n)
        frames.append([rfe.num_frames(int(v), cfg) for v in n])
        i += 1
        el = time.perf_counter() - t0
        marks.append(el)
        if el + el / i >= r.seconds:
            break
    results[prev[0]] = read(prev[1])
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    del x, lengths, feats, em, handle, prev
    audio_s = float(sum(v.sum() for v in samples)) / sr
    utts = sum(len(v) for v in samples)
    out = {"end_to_end": {"audio_s_per_s": audio_s / window_s, "setup_s": setup_s},
           "attempted": utts, "memory_peak_bytes": peak}
    print(f"[decode] {i} batches, {utts} utterances, {audio_s:.1f} audio-s in {window_s:.2f} s: "
          f"{audio_s / window_s:.2f} audio-s/s; set-up {setup_s:.2f} s; batches dispatched at "
          f"{[round(m, 2) for m in marks]} s", file=sys.stderr)

    window_work = Work()
    for n, fr in zip(samples, frames):
        window_work = window_work + frontend_counts.work(n, fr, cfg) + am.forward_work(fr, cfg)
    layer = {"window": {"decode": (window_work, window_s)}}
    if r.trace:
        x, lengths, n = traffic.audio_batch(t, sr, r.seed, i, dev)
        fr = [rfe.num_frames(int(v), cfg) for v in n]
        with trace.profiled() as prof:
            read(dispatch(x, lengths)[2])
        t1 = time.perf_counter()
        layer["summary"] = trace.summarize(prof, SPANS)
        print(f"[decode] trace read in {time.perf_counter() - t1:.1f} s", file=sys.stderr)
        layer["work"] = {"frontend": frontend_counts.work(n, fr, cfg),
                         "scorer": am.forward_work(fr, cfg)}
        layer["steps"] = {"decoder": max(fr)}
        del x, lengths
    out["layer"] = layer

    # the program's state goes before the reference runs
    del s
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out.update(check(r, d, weights, kept, longest, results, frames))
    return out


def check(r, d, weights, kept, longest, results, frames) -> dict:
    """Hold a sample of the window's utterances, with the first batch's
    longest, to the reference."""
    cfg, dev = r.cfg, r.device
    am = spec.model(cfg)
    rng = np.random.default_rng(traffic.sub_seed(r.seed, 5))
    rest = sorted(k for k in kept if k != longest)
    n_check = min(r.traffic["check_utterances"] - 1, len(rest))
    picks = [longest] + [rest[j] for j in rng.choice(len(rest), n_check, replace=False)]
    model = rdec.Model(cfg, d.words, d.vocab, d.ngrams)
    loop = rsearch.WordLoop(model, d.words, dev)
    quant = QUANT[r.control] if r.control else None
    gaps = {"features_max_abs": 0.0, "emissions_max_abs": 0.0, "score_gap": 0.0,
            "search_gap": 0.0}
    limits = cfg["limits"]["decode"]
    failed, words, same = 0, 0, 0
    for b, row in picks:
        audio, pf, pe = kept[(b, row)]
        nfr = frames[b][row]
        res = results[b][row]
        x = audio.cpu().numpy()
        rf = torch.from_numpy(rfe.features(x, d.lda, cfg)).to(dev)
        re = am.reference_scores(rf, d, weights, cfg)
        score, lemmas, ends = res.score, [lemma.primary_orth for lemma in res.lemmas], res.word_ends
        if quant is not None:  # the reference in a lower precision, in the program's place
            pf = rfe.features_lowered(audio, d.lda, cfg, QUANT["tf32"])
            pe = am.reference_scores(pf, d, weights, cfg, quant)
            score, lemmas, ends = loop.best(pe[:nfr], bf16_round)
        emis = pe[:nfr].double()
        best, best_words, _ = loop.best(emis)
        own = rdec.path_score(model, lemmas, ends, nfr, emis.cpu().numpy())
        words += len(lemmas)
        same += lemmas == best_words
        g = {"features_max_abs": float((pf[:nfr].double() - rf).abs().max()),
             "emissions_max_abs": float((emis - re).abs().max()),
             "score_gap": abs(score - own), "search_gap": abs(score - best)}
        print(f"[decode] batch {b} row {row}: {nfr} frames, {len(lemmas)} words "
              f"({len(best_words)} in the best path, the same: {lemmas == best_words}), score "
              f"{score!r}, its words' best {own!r}, the best path {best!r}", file=sys.stderr)
        g = {k: v if math.isfinite(v) else math.inf for k, v in g.items()}
        if any(g[k] > lim for k, lim in limits.items()):
            failed += 1
        for k in g:
            gaps[k] = max(gaps[k], g[k])
    print(f"[decode] checked {len(picks)} utterances, {words} words; {same} decoded to the "
          f"best path's words; not compared: "
          f"{ {k: v for k, v in gaps.items() if k not in limits} }", file=sys.stderr)
    return {"failed": failed, "check": {k: (gaps[k], lim) for k, lim in limits.items()}}
