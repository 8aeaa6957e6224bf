"""The port's decode benchmark on one CUDA card.

    python -m rasr_tpu_torch.bench

The counterpart of the reference's ``bench.py`` (its ``main``): the
complete pipeline, frontend -> GMM (or conformer) scorer -> prefix-tree
beam decode -> host results, over batches of synthetic audio staged on
the card, on ``synthetic.build_setup``'s production-shape setup (5k
words, 2000 x 8 x 45 GMMs, bench.py's production beam). Before timing it
runs two canaries on the card: bench.py's planted two-word decode under
both of its canary beams, on the within-word tree and the across-word
network, and, in place of bench.py's CPU-vs-TPU canary, a small batch
decoded on the card and on the CPU on the paths the timed decode does
not take (the across-word network, the 4-gram LM's two-key
recombination, the word-set bigram lookahead, compact branch slots with
the LM-ranked word ends): the same words, scores within 1e-2 relative.

Each timed batch is dispatched before the last batch's results are read
(a depth-2 pipeline); the result is the median of ``BENCH_WINDOWS``
windows of ``BENCH_ITERS`` batches each. The knobs are bench.py's
``BENCH_*`` environment variables (:data:`KNOBS`); ``BENCH_UNROLL`` (a
TPU scan setting) has no counterpart and raises.

Prints ONE JSON line, ``{"metric": "torch_decode_throughput", "value",
"unit": "audio_seconds/s/chip", ...}``, with the per-window rates, the
device and the card's name and power limit. The metric is the port's
own: its numbers are not comparable to the TPU history of bench.py's
``decode_throughput``, and it carries no ``vs_baseline``. Without a card
it raises; :func:`run` takes ``device="cpu"`` for tests.

``BENCH_TRAIN=1`` times a training step instead (bench.py's
``train_bench``): ``ConformerEncoderNet`` at ``BENCH_TRAIN_DMODEL`` x
``BENCH_TRAIN_BLOCKS`` (512 x 12, 8 heads, ``BENCH_CLASSES`` outputs,
``BENCH_NN_DTYPE`` products) trained by ``SequenceTrainer(TrainConfig())``
on ``BENCH_TRAIN_BATCH`` x ``BENCH_TRAIN_FRAMES`` (16 x 400) frames of 45
dims. It prints one ``torch_train_mfu`` line: the median step time of 3
windows of ``BENCH_TRAIN_STEPS`` steps on a batch resident on the device,
each window ending in ``torch.cuda.synchronize()``; the same with the
batch uploaded from the host every step; frames/s; the FLOP per step
counted from the shapes (:func:`train_step_flop`) over the step time, and
that as a share of ``BENCH_TRAIN_PEAK_TFLOPS`` (989, the H100 SXM's dense
bf16 rate at 700 W).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from .corpus.lexicon import Lexicon, build_default_silence
from .device import card_tag, resolve
from .models.allophone import Allophone, AllophoneState
from .models.hmm import HmmTopology, TransitionModel
from .models.lm.arpa import NgramLm
from .models.lm.ngram import compile_ngram
from .models.nn import ConformerEncoderNet, conformer_flop
from .models.tying import MonophoneStateTying
from .search.decoder import BeamConfig, TreeDecoder
from .search.lookahead import build_bigram_lookahead
from .search.tree import build_prefix_tree
from .synthetic import CONFORMER, PRODUCTION_BEAM, build_setup
from .train.nn_trainer import SequenceTrainer, TrainConfig


def _flag(v: str) -> bool:
    return bool(int(v))


#: run() keyword -> (bench.py's environment variable, parser, default)
KNOBS = {
    "words": ("BENCH_WORDS", int, 5000),
    "classes": ("BENCH_CLASSES", int, 2000),
    "batch": ("BENCH_BATCH", int, 64),
    "audio_s": ("BENCH_AUDIO_S", float, 10.0),
    "iters": ("BENCH_ITERS", int, 3),
    "windows": ("BENCH_WINDOWS", int, 3),
    "train": ("BENCH_TRAIN", _flag, False),
    # the training step (bench.py:476-586)
    "train_dmodel": ("BENCH_TRAIN_DMODEL", int, 512),
    "train_blocks": ("BENCH_TRAIN_BLOCKS", int, 12),
    "train_batch": ("BENCH_TRAIN_BATCH", int, 16),
    "train_frames": ("BENCH_TRAIN_FRAMES", int, 400),
    "train_steps": ("BENCH_TRAIN_STEPS", int, 20),
    "train_peak_tflops": ("BENCH_TRAIN_PEAK_TFLOPS", float, 989.0),
    "unroll": ("BENCH_UNROLL", int, 1),
    # build_setup's network, LM, lookahead and scorer
    "net_cache": ("BENCH_NET_CACHE", str, ""),
    "lm_order": ("BENCH_LM_ORDER", int, 2),
    "skip_scope": ("BENCH_SKIP_SCOPE", str, "phone"),
    "across_word": ("BENCH_ACROSS", _flag, False),
    "ctx_groups": ("BENCH_CTX_GROUPS", int, 0),
    "la_order": ("BENCH_LA_ORDER", int, 1),
    "la_classes": ("BENCH_LA_CLASSES", int, 64),
    "la_smooth": ("BENCH_LA_SMOOTH", float, 0.0),
    "lookahead_update": ("BENCH_LA_UPDATE", str, "arc"),
    "branch_width": ("BENCH_BRANCH_WIDTH", int, -1),
    "scorer": ("BENCH_SCORER", str, "gmm"),
    "nn_dtype": ("BENCH_NN_DTYPE", str, "bfloat16"),
    # the production beam's fields (bench.py:224-275)
    "max_hyps": ("BENCH_MAX_HYPS", int, PRODUCTION_BEAM.max_hyps),
    "branch_hyps": ("BENCH_BRANCH_HYPS", int, PRODUCTION_BEAM.branch_hyps),
    "word_end_limit": ("BENCH_WORD_END", int, PRODUCTION_BEAM.word_end_limit),
    "root_hyps": ("BENCH_ROOT_HYPS", int, PRODUCTION_BEAM.root_hyps),
    "root_arc_limit": ("BENCH_ROOT_CAP", int, PRODUCTION_BEAM.root_arc_limit),
    "expansion_limit": ("BENCH_EXPANSION", int, PRODUCTION_BEAM.expansion_limit),
    "root_select": ("BENCH_ROOT_SELECT", int, PRODUCTION_BEAM.root_select),
    "deferred_emission": ("BENCH_DEFER", _flag, PRODUCTION_BEAM.deferred_emission),
}
_SETUP = ("net_cache", "lm_order", "skip_scope", "across_word", "ctx_groups", "la_order",
          "la_classes", "la_smooth", "lookahead_update", "branch_width", "scorer", "nn_dtype")
_BEAM = ("max_hyps", "branch_hyps", "word_end_limit", "root_hyps", "root_arc_limit",
         "expansion_limit", "root_select", "deferred_emission")

METRIC = "torch_decode_throughput"
TRAIN_METRIC = "torch_train_mfu"
TRAIN_FEAT_DIM = 45
#: bench.py's cross-backend tolerance on the scores of the same decode
CANARY_RTOL = 1e-2


def knobs_from_env(env=os.environ) -> dict:
    """The :data:`KNOBS` that ``env`` sets, parsed."""
    return {k: parse(env[var]) for k, (var, parse, _) in KNOBS.items() if var in env}


def _canary_lexicon(words):
    lex = Lexicon()
    build_default_silence(lex)
    for orth in words:
        lex.add_lemma([orth], [(list(orth.lower()), 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    return lex, topo, MonophoneStateTying(lex, topo)


def planted_canary(device) -> None:
    """bench.py's planted decode (``bench.py:279``): emissions that spell
    ``si si a a b b`` decode to ``[SILENCE] AB`` ending at frames 1 and 5,
    under both of its canary beams (the plain one and the production
    pruning: root select, deferred emission, root and branch caps), on
    the within-word tree and on the across-word network of the same
    lexicon (the monophone tying collapses its contexts). Raises when a
    decode on ``device`` misses."""
    device = resolve(device)
    lex, topo, tying = _canary_lexicon(["AB", "BA"])
    lm = NgramLm.train_from_text([["AB", "BA"], ["BA", "AB"]], order=2)

    def cls_of(sym):
        return tying.classify(AllophoneState(Allophone(lex.phonemes[sym].id), 0))

    seq = [cls_of("si")] * 2 + [cls_of("a")] * 2 + [cls_of("b")] * 2
    emis = np.full((1, len(seq), tying.num_classes), 50.0, np.float32)
    for t, c in enumerate(seq):
        emis[0, t, c] = 0.0
    emis = torch.from_numpy(emis).to(device)
    for across in (False, True):
        net = build_prefix_tree(lex, tying, topo, TransitionModel(), lm_vocab=lm.vocab,
                                across_word=across)
        for beam in (  # bench.py:332-337
            BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.5),
            BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.5, root_hyps=4,
                       root_select=8, root_arc_limit=2, branch_hyps=16, deferred_emission=True),
        ):
            dec = TreeDecoder(net, compile_ngram(lm), beam, device=device)
            (res,) = dec.decode_scores(emis, np.array([len(seq)]))
            got = [lemma.primary_orth for lemma in res.lemmas]
            if got != ["[SILENCE]", "AB"] or res.word_ends != [1, 5]:
                raise AssertionError(f"planted canary on {device} ({net.num_final_states} final "
                                     f"states, {beam}): {got} @ {res.word_ends}")


def cross_device_canary(device) -> list:
    """A small batch decoded on ``device`` and on the CPU (bench.py's
    ``_cross_backend_canary`` without its RNN fusion, which the port does
    not have, and its TPU layout cases): the across-word network, the
    4-gram LM under the two-key recombination, the word-set bigram
    lookahead on both networks, and compact branch slots with LM-ranked
    word ends and a word-end beam. Raises unless every decode gives the
    same words and scores within :data:`CANARY_RTOL`; returns the names
    of the cases."""
    device = resolve(device)
    lex, topo, tying = _canary_lexicon(["AB", "BA", "AA", "BAB"])
    trans = TransitionModel()
    texts = [["AB", "BA"], ["AB", "AA"], ["BA", "BAB"], ["BAB", "AB"]] * 2
    lm2 = NgramLm.train_from_text(texts, order=2)
    lm4 = NgramLm.train_from_text(texts, order=4)
    uni = {wid: lm2.score((), wid) for wid in lm2.vocab.values()}
    within = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm2.vocab, lm_unigrams=uni)
    across = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm2.vocab, lm_unigrams=uni,
                               across_word=True)
    T = 6
    emis = np.random.default_rng(42).uniform(0.0, 6.0, size=(2, T, tying.num_classes)).astype(
        np.float32)
    nf = np.array([T, T - 2])
    cfg = BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.8)
    cases = {
        "across-word": (across, lm2, None, cfg),
        "4gram-two-key": (within, lm4, None, dataclasses.replace(cfg, force_unpacked_keys=True)),
        "bigram-la": (within, lm2, build_bigram_lookahead(within, lm2, num_classes=8), cfg),
        "branch-width+we-rank": (across, lm2, None, dataclasses.replace(
            cfg, branch_hyps=8, branch_width=24, word_end_rank_lm=True, word_end_beam=60.0)),
        "across-word+bigram-la": (across, lm2, build_bigram_lookahead(across, lm2, num_classes=8),
                                  cfg),
    }
    for name, (net, lm, bla, beam) in cases.items():
        a, b = (TreeDecoder(net, compile_ngram(lm), beam, bigram_la=bla, device=d)
                .decode_scores(torch.from_numpy(emis).to(d), nf) for d in (device, "cpu"))
        for x, y in zip(a, b):
            if x.words != y.words or abs(x.score - y.score) > CANARY_RTOL * max(1.0, abs(y.score)):
                raise AssertionError(f"{device} vs cpu decode ({name}): {x.words} {x.score} vs "
                                     f"{y.words} {y.score}")
    return list(cases)


def _device_record(device) -> dict:
    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": torch.cuda.device_count() if cuda else 1}


def train_step_flop(cfg: dict, classes: int, batch: int, frames: int,
                    in_dim: int = TRAIN_FEAT_DIM) -> float:
    """FLOP of one training step of ``ConformerEncoderNet(**cfg)`` on
    ``batch`` x ``frames``: a forward pass (``models.nn.conformer_flop``,
    both dtypes) and a backward of twice it."""
    return 3.0 * batch * frames * sum(conformer_flop(cfg, in_dim, classes, frames))


def train_bench(device, k: dict, log) -> dict:
    """The ``BENCH_TRAIN=1`` step on ``device`` at the knobs ``k``; returns
    the result record."""
    cuda = device.type == "cuda"
    cfg = dict(CONFORMER, d_model=k["train_dmodel"], num_blocks=k["train_blocks"])
    classes, B, T = k["classes"], k["train_batch"], k["train_frames"]
    net = ConformerEncoderNet(classes, TRAIN_FEAT_DIM, **cfg, compute_dtype=k["nn_dtype"],
                              device=device)
    trainer = SequenceTrainer(net, classes, TrainConfig())
    trainer.init_params()
    rng = np.random.default_rng(0)
    host = (rng.normal(size=(B, T, TRAIN_FEAT_DIM)).astype(np.float32),
            rng.integers(0, classes, size=(B, T)).astype(np.int32),
            np.ones((B, T), np.float32))
    resident = tuple(torch.from_numpy(a).to(device) for a in host)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def window(n, upload=False) -> float:
        """Seconds per step over ``n`` steps, ending in a synchronize."""
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            batch = tuple(torch.from_numpy(a).to(device) for a in host) if upload else resident
            trainer._update(*batch)
        sync()
        return (time.perf_counter() - t0) / n

    t0 = time.perf_counter()
    window(1)
    log(f"train warm-up {time.perf_counter() - t0:.1f} s")
    window(2)  # settle the allocator and the dispatch path
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    steps = k["train_steps"]
    step_s = statistics.median(window(steps) for _ in range(3))
    upload_s = statistics.median(window(steps, upload=True) for _ in range(3))
    flop = train_step_flop(cfg, classes, B, T)
    tflops = flop / step_s / 1e12
    mfu = tflops / k["train_peak_tflops"]
    log(f"train step {step_s * 1e3:.2f} ms ({B}x{T} frames, d{cfg['d_model']}x"
        f"{cfg['num_blocks']}, {k['nn_dtype']}) | {B * T / step_s:.0f} frames/s | "
        f"{tflops:.2f} TFLOP/s ({flop:.4e} FLOP per step) | MFU {mfu:.2%} of "
        f"{k['train_peak_tflops']:g} | with per-step upload {upload_s * 1e3:.2f} ms")
    return {
        "metric": TRAIN_METRIC,
        "value": 100.0 * mfu,
        "unit": "percent_of_peak",
        "step_ms": step_s * 1e3,
        "frames_per_s": B * T / step_s,
        "achieved_tflops": tflops,
        "step_ms_with_upload": upload_s * 1e3,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "flop_per_step": flop,
        "knobs": {k_: k[k_] for k_ in KNOBS if k[k_] != KNOBS[k_][2]},
        "device": _device_record(device),
        "card": card_tag() if cuda else None,
    }


def run(device=None, out=None, **knobs) -> dict:
    """Canaries, then the timed decode on ``device`` (the card when None),
    or with ``train=True`` the timed training step; ``knobs`` are
    :data:`KNOBS` keywords over their defaults. Prints the result line to
    ``out`` (stdout) and returns it."""
    unknown = set(knobs) - set(KNOBS)
    if unknown:
        raise TypeError(f"unknown bench knobs {sorted(unknown)}")
    k = {name: default for name, (_, _, default) in KNOBS.items()}
    k.update(knobs)
    if k["unroll"] != 1:
        raise NotImplementedError("BENCH_UNROLL unrolls the TPU's frame scan; the port's frame "
                                  "loop is eager PyTorch and has no counterpart")
    device = resolve(device)
    cuda = device.type == "cuda"

    def log(msg):
        sys.stderr.write(f"[bench] {msg}\n")

    if k["train"]:
        record = train_bench(device, k, log)
        print(json.dumps(record), file=out or sys.stdout, flush=True)
        return record

    planted_canary(device)
    log("canary ok: [SILENCE] AB @ [1, 5] (plain + rsel/defer; within-word + across-word)")
    crossed = cross_device_canary(device)
    log(f"canary ok: {device} == cpu {crossed}")

    t0 = time.time()
    beam = dataclasses.replace(PRODUCTION_BEAM, **{f: k[f] for f in _BEAM})
    s = build_setup(num_words=k["words"], num_classes=k["classes"], device=device, beam=beam,
                    **{f: k[f] for f in _SETUP})
    B, audio_s, iters = k["batch"], k["audio_s"], k["iters"]
    S = int(audio_s * 16000)
    rng = np.random.default_rng(1)
    samples = torch.from_numpy(rng.normal(size=(B, S)).astype(np.float32) * 0.1).to(device)
    lengths = torch.full((B,), S, dtype=torch.int64, device=device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0
    log(f"setup {setup_s:.1f} s: tree {s.tree.stats()}, device {device}")

    def dispatch():
        feats, nf = s.frontend(samples, lengths)
        return s.decoder.decode_scores_device(s.scorer(feats), nf)

    t0 = time.time()
    s.decoder.results_from_device(dispatch())
    warmup_s = time.time() - t0
    log(f"warm-up {warmup_s:.1f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rates = []
    for w in range(k["windows"]):
        t0 = time.time()
        prev = None
        for _ in range(iters):
            handle = dispatch()
            if prev is not None:
                s.decoder.results_from_device(prev)
            prev = handle
        s.decoder.results_from_device(prev)
        rates.append(iters * B * audio_s / (time.time() - t0))
        log(f"window {w}: {rates[-1]:.1f} audio-s/s")
    record = {
        "metric": METRIC,
        "value": statistics.median(rates),
        "unit": "audio_seconds/s/chip",
        "windows": rates,
        "batch": B,
        "audio_s": audio_s,
        "iters": iters,
        "knobs": {k_: k[k_] for k_ in KNOBS if k[k_] != KNOBS[k_][2]},
        "setup_s": setup_s,
        "warmup_s": warmup_s,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "canaries": ["planted"] + crossed,
        "device": _device_record(device),
        "card": card_tag() if cuda else None,
    }
    print(json.dumps(record), file=out or sys.stdout, flush=True)
    return record


def main() -> int:
    run(**knobs_from_env())
    return 0


if __name__ == "__main__":
    sys.exit(main())
