#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``rasr_tpu_torch/csrc/`` and
holds each against its plain PyTorch version at its path's shapes and at
ragged ones. Then it drives every path of the port, each with the launch
counters set to 0 just before it and read just after:

- the word-end and row-gather microbenches
  (``rasr_tpu_torch.examples.wordend_microbench`` / ``gather_microbench``),
  which time their kernel against its plain version;
- the planted two-word canary under both of bench.py's canary configs,
  on the within-word tree and on the across-word network;
- the main path: batches of synthetic 10 s audio through the full-width
  benchmark setup (5k words, 2000 x 8 x 45 GMMs, K=1024) under bench.py's
  production beam (root select 512, deferred emission, root-arc cap 160),
  ``FeatureFrontend -> GmmFeatureScorer -> decode_scores_device ->
  results_from_device``;
- the same setup under decoder slice A's beam, at reduced depth;
- the across-word path: the same pipeline and beam at full width over the
  across-word network of a tying with 4 context groups, with word-set
  bigram lookahead and compact branch slots (one warm-up, one timed batch);
- the 4-gram path: a 4-gram LM with trigram lookahead under survivor
  updates, word-scope skips and compact slots, at B=16 (one timed batch);
- the conformer path: bench.py's hybrid conformer (d=512, 12 blocks, 8
  heads, bf16 products; ``build_setup(scorer="conformer")``) in front of
  the headline decoder, B=64 x 10 s after a warm-up batch, with the
  scorer's device time beside its bound; its float32 twin on the card
  must match the same weights on the CPU, and the bf16 network the
  float32 one;
- the streaming path (``rasr_tpu_torch.examples.streaming_bench``): the
  main path's decoder fed its GMM emissions of 64 x 998 frames in blocks
  of 16, 32 and 128 frames, each stream equal to the offline decode;
- the recognizer path: ``OfflineRecognizer`` over a synthesized Bliss
  corpus of 64 wavs of 3-10 s (orths from the main path's lexicon) with
  the main path's setup, once best-only and once writing a lattice
  archive and a CTM file; its words must be ``decode_scores``' on the
  same features, each lattice must hold its best path (oracle WER 0) and
  the archive must give back the lattices built from the decode;
- the fmllr path: the recognizer corpus (8 speakers) Viterbi-aligned,
  per-speaker fMLLR statistics and transforms for 4 of its speakers, then
  ``OfflineRecognizer(feature_transforms=...)`` with those transforms and
  with identity ones (which must give the words of the plain run);
- the bench path: ``python -m rasr_tpu_torch.bench``'s ``run`` at its
  defaults at reduced depth (both canaries, then 1 window of 2 batches
  of 64 x 10 s);
- the align-em path: the main path's setup on 64 x 10 s with orths of
  8-20 words from its lexicon: features (MFCC kernel), flat-start labels,
  one EM accumulate / estimate, a Viterbi realign (GMM kernel), Baum-Welch
  posteriors and an LDA estimate from spliced features; the card's
  alignments, posteriors and statistics against the CPU's, and the DP
  loops' launches per frame under ``torch.profiler``;
- the train-ce path: ``python -m rasr_tpu_torch.bench``'s ``BENCH_TRAIN=1``
  step (the d=512 x 12-block conformer, bf16, B=16 x 400); a float32
  conformer step on the card against the CPU, the bf16 loss falling over
  20 steps, and a mid-epoch checkpoint resume bit-equal to a straight run;
- the train-lfmmi path: LF-MMI and sMBR steps of the same conformer at
  B=16 x 400 over a phone-bigram denominator of the main path's 40 phones;
  the loss and emission gradients of B=2 on the card against the CPU's;
- the rnn-fusion path: an RNN LM (E=64, H=128) trained on the card for 10
  full-batch Adam epochs on 2000 x 12 words of the main path's orths, fused
  at weight 0.5 into the main path's decoder; a 1-s warm-up and one timed
  batch of 64 x 10 s from audio (its rate beside the n-gram-only main
  path's, the state pools' size, the peak memory, the frame loop's launches
  and device time beside the n-gram decoder's, word_scores and cell_step
  beside their bounds); the fused decode of B=4 x 3 s on the card against
  the CPU; the batch's emissions streamed in blocks of 128 (the pool at 2K
  + R x Tb rows after every feed, streamed == offline); the recognizer
  corpus with lattices and 10-best lists (rank 0 == the best path); 4 of
  its lattices rescored with the RNN LM and decoded as confusion networks;
  one MMI EBW update of the main path's GMMs from them (the card's
  accumulators against the CPU's);
- the frontend-ext path: the bench batch through ``FeatureFrontend`` with
  the energy column (out of the MFCC kernel's own launch), sliding CMVN
  over 300 frames, deltas of order 2 and VTLN at 0.92 (51 dimensions),
  scored by the bench GMMs drawn at 51 dimensions and decoded under the
  production beam; the MFCC kernel against its plain version on those
  operands; card == CPU features and decode on B=2 x 3 s; the gammatone
  frontend on the batch, timed beside its bound, card == CPU on B=2 x 3 s;
  the VTLN grid search over the seven default factors on 8 utterances
  with the align-em path's EM model, card == CPU;
- the tools path: the main path's setup written as files (the lexicon as
  XML, the LM as ARPA, the LDA as .npy) and the recognizer corpus driven
  through ``python -m rasr_tpu_torch.tools.<tool>``, one process each, at
  the main path's width: lm-util, flat-start monophone training to 8
  densities, a CART of 2000 leaves, triphone training to 2000 x 8 x 45,
  and the recognizer under the production beam (given as ``search.*``
  parameters, its logged beam asserted) twice, building and then loading
  its network image (equal words, WER line, lattices and CTM); an
  in-process ``OfflineRecognizer`` from the same files gives the tool's
  words, and the tool on the CPU on the 4 shortest segments the card's
  words and WER line; the LM parsed by the native library into packed
  per-slot tables decodes the main batch (and the 4-gram path's LM, B=16)
  bit-equal to the bucketed tables, and the same tables forced onto the
  one-gather-per-probe route answer as the replicated windows do (one
  lookup of each timed); a class LM of 200 classes decodes B=4 x 3 s on
  the card as on the CPU;
- the parallel path (``rasr_tpu_torch.parallel``): a world of one rank
  over NCCL in this process (``OfflineRecognizer(mesh=)`` over the
  recognizer corpus == the recognizer, WER counters merged by
  ``psum_counters``), then two processes of this script
  (``--parallel-rank``) sharing the card over gloo: the data-parallel
  recognizer again, ``ShardedGmmScorer`` over a 2-way model axis ==
  ``GmmFeatureScorer`` (min and LSE), ``dp_accumulate`` over the 64 x 998
  frames == one accumulation, the exact partitioned beam on 16 x 10 s ==
  the single decode (the production beam's agreement reported), the
  per-frame ``all_gather`` timed, ``SpFrontend`` and ``sp_viterbi_align``
  on a 5-min recording == ``FeatureFrontend`` and ``viterbi_align``, and
  ``dryrun_multichip(2)``; then both ported examples (``streaming_demo``,
  ``beam_sweep``) once;
- the wfst path: a command grammar over 200 words of the lexicon (500
  sentences through ``FsaGrammarLm``, determinized and minimized, each
  word arc expanded into its HMM state chain) compiled by
  ``compile_wfst``, its re-entry bigram lookahead, the bench batch through
  MFCC -> GMM -> the decoder under the production beam; card == CPU on
  B=2 x 3 s, and one card lattice as an FSA whose best path is the
  decoder's.

A small batch decoded on the card and on the CPU must agree on every
path, and so must the lattices of a 4 x 3 s batch. Prints per-stage
times tagged with the card's name and power limit, one JSON line of
kernel records (``launches`` from the main path, or the microbench of a
kernel the main path does not run; ``launches_by_path`` from every path
that read the kernel's count), and as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It needs a CUDA card and the
repository beside it (``--parallel-rank`` is its own rank processes'
entry).
"""

import contextlib
import io
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# fp32 sums taken in another order than the plain version's (the kernels
# accumulate per thread with FMAs, cuBLAS in its own tiling):
GMM_RTOL, GMM_ATOL = 1e-5, 1e-3  # scores ~50-150: ~1e-7 relative rounding
MFCC_RTOL, MFCC_ATOL = 2e-4, 2e-4  # the reference's own kernel tolerance
# the word-end and row-gather kernels are held bit-equal (torch.equal):
# one gather per output, two fp32 adds in the plain version's order
# CUDA vs CPU decode of the same scores: identical float ops, so words
# must match exactly; scores within bench.py's cross-backend 1e-2
DECODE_RTOL = 1e-2
# the conformer's emissions (10 x nats, ~50-80): its float32 twin on the
# card against the CPU (cuBLAS vs the CPU's sums, no TF32), and the bf16
# network against the float32 one (bf16 products: ~0.3 max and ~0.06 mean
# on a 120-frame input at d=512 on the CPU, at 1, 2 and 4 blocks)
NN_F32_RTOL, NN_F32_ATOL = 1e-4, 1e-2
NN_BF16_RTOL, NN_BF16_ATOL = 1e-2, 1.0

# the training side: Viterbi and Baum-Welch scores of the same emissions on
# the card and the CPU (identical float ops in another order of launches),
# EM / LDA / fMLLR statistics (float32 sums in another order: index_add_ and
# products tiled otherwise), one float32 conformer step (cuBLAS vs the CPU's
# sums, no TF32), LF-MMI and sMBR losses and emission gradients
ALIGN_RTOL, EM_RTOL = 1e-4, 1e-4
# Baum-Welch posteriors exp(-(alpha + beta - total)) of float32 costs near
# 1e5 (10-s utterances) carry the rounding of the two recursions (T
# roundings at an ulp of 0.0078): each frame's sum is 1 within
# OCC_SQRT_T_ULPS x sqrt(T) ulps of the total in log, and the card's (its
# own exp and log) are within GAMMA_ULPS ulps of the CPU's
OCC_SQRT_T_ULPS, GAMMA_ULPS = 2, 4
TRAIN_F32_RTOL, TRAIN_F32_ATOL = 1e-3, 1e-4
LFMMI_RTOL = 1e-4

BATCH, AUDIO_S, TIMED_BATCHES = 64, 10.0, 2
SLICE_A_BATCH = 16  # slice A at reduced depth: one timed batch
#: the slice-C paths (``synthetic.PATHS``): batch, and whether a full
#: warm-up batch precedes the timed one (else a 1-s one)
SLICE_C = {"across-word": (BATCH, True), "4-gram": (16, False)}
RECOGNIZER_SEGMENTS = 64  # one batch of 3-10 s wavs
RECOGNIZER_SPEAKERS, FMLLR_SPEAKERS = 8, 4  # fMLLR for 4 of the corpus's 8 speakers
ALIGN_WORDS = (8, 21)  # words per 10-s utterance of the align-em path
# the bf16 loss must fall by BF16_FALL nats over BF16_STEPS Adam steps (at
# the default rate: 0.6 in 20 steps at d=32 on the CPU)
BF16_STEPS, BF16_FALL, LFMMI_STEPS = 20, 0.2, 2
# the bench entry at reduced depth (its defaults: 3 windows of 3 batches)
BENCH_WINDOWS, BENCH_ITERS = 1, 2
# Baum-Welch on the CPU for the first ALIGN_CPU_BW utterances of the batch
ALIGN_CPU_BW = 16
# the rnn-fusion path: the RNN LM (LstmLmModule's default widths) trained
# on RNN_SENTENCES x RNN_SENTENCE_WORDS words drawn from the main path's
# orths, fused at RNN_WEIGHT; streamed in blocks of RNN_STREAM_BLOCK; the
# recognizer's n-best depth; lattices rescored and trained on
RNN_EMBED, RNN_HIDDEN, RNN_EPOCHS, RNN_WEIGHT = 64, 128, 10, 0.5
RNN_SENTENCES, RNN_SENTENCE_WORDS, RNN_STREAM_BLOCK = 2000, 12, 128
RNN_NBEST, RNN_LATTICES = 10, 4
# decode frames profiled per path (launches and device time per frame)
PROFILE_FRAMES = 50
# the frontend-ext path: MFCC with energy, sliding CMVN (300 frames),
# deltas of order 2 and VTLN at VTLN_ALPHA: 17 x 3 = 51 dimensions, scored
# by the bench GMMs drawn at 51 dimensions. Its features on the card
# against the CPU: the sliding variance E[x^2] - mean^2 cancels ~5 digits
# where a window's log energy barely varies, so the cepstra's float32
# differences (the kernel's 3xTF32 DFT against the CPU's sums) grow by up
# to ~1e3 there (tests/test_torch_frontend.py: 0.031 between the two
# packages on the CPU); the gammatone features within 1e-4 relative
# (float32 convolutions without TF32, summed in another order); VTLN
# estimated over the seven default factors on VTLN_BATCH utterances, each
# factor's total alignment cost within ALIGN_RTOL of the CPU's
VTLN_ALPHA, VTLN_BATCH = 0.92, 8
FEAT_EXT_RTOL, FEAT_EXT_ATOL = 2e-4, 5e-2
GT_RTOL, GT_ATOL = 1e-4, 1e-5
# the wfst path: a command grammar of WFST_SENTENCES sentences of 2-5
# words drawn from WFST_WORDS words of the main path's lexicon, made
# deterministic and minimal, each word arc expanded into the word's HMM
# state chain; its re-entry lookahead with WFST_LA_CLASSES history classes
WFST_WORDS, WFST_SENTENCES, WFST_LA_CLASSES = 200, 500, 64
WFST_STOP_COST = 5.0  # stopping a command before its sentence ends
# the tools phase: flat-start training for TOOLS_ITERATIONS iterations with
# TOOLS_SPLITS density splits (1 -> 8 densities, the main path's), a CART of
# up to TOOLS_MAX_LEAVES leaves (the main path's 2000 tied classes), the
# recognizer on the cpu on the TOOLS_CPU_SEGMENTS shortest segments, the
# 4-gram packed-LM decode at PACKED_4GRAM_BATCH, and a class LM of
# CLASSLM_CLASSES classes trained on CLASSLM_SENTENCES class sentences
TOOLS_ITERATIONS, TOOLS_SPLITS, TOOLS_MAX_LEAVES, TOOLS_CPU_SEGMENTS = 5, 3, 2000, 4
PACKED_4GRAM_BATCH, CLASSLM_CLASSES, CLASSLM_SENTENCES = 16, 200, 500
TOOLS_SEED = 10

# the parallel phase (parallel/ over torch.distributed): a world of one
# rank over NCCL in this process, then PARALLEL_WORLD processes sharing the
# card over gloo (NCCL puts no two ranks of one communicator on one
# device). The partitioned beams decode PARALLEL_BATCH x 10 s; the exact
# beam covers every slice (root and branch hyps = K, no root-arc cap, root
# select, expansion limit or deferred emission: the reference's exactness
# precondition), words exact and scores within PART_RTOL; the time-sharded
# frontend and alignment take a SP_SECONDS recording (~30,000 frames),
# the alignment through a linear graph of SP_STATES states, the features
# within the card-vs-CPU features gate; the DP EM statistics over the
# 64 x 998 frames within EM_RTOL
PARALLEL_WORLD, PARALLEL_BATCH, PARALLEL_SEED = 2, 16, 21
PART_RTOL = 1e-5
SP_SECONDS, SP_STATES = 300.0, 60
FEAT_RTOL, FEAT_ATOL = 1e-3, 1e-3
GATHER_REPS = 100  # all_gathers of the exact beam's per-frame payload, timed

# NVIDIA's H100 SXM data sheet (dense, at 700 W): fp32 outside the tensor
# cores, TF32 on them, and HBM3. A kernel's bound is the larger of its
# operations and its bytes (each input read once, each output written
# once) over these. The GMM and MFCC kernels take their products on the
# tensor cores as three TF32 products each (3xTF32, fp32 accuracy), so
# those products count three times at the TF32 rate.
FP32_FLOPS, TF32_FLOPS, HBM_BYTES_S = 67e12, 495e12, 3.35e12
BF16_FLOPS = 989e12  # dense, on the tensor cores


def bound(flop: float, nbytes: float, tf32x3_flop: float = 0.0):
    """(bound_ms, bound_by) of work of ``flop`` fp32 operations on the fp32
    pipes and ``tf32x3_flop`` fp32-accurate operations on the tensor cores
    (the two units run side by side), moving ``nbytes``."""
    t_op = max(flop / FP32_FLOPS, 3.0 * tf32x3_flop / TF32_FLOPS) * 1e3
    t_mem = nbytes / HBM_BYTES_S * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def check_close(name, got, ref, rtol, atol) -> float:
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} values off (max abs err {err.max().item():.3e})"
        )
    return float(err.max().item())


def check_equal(name, got, want) -> None:
    import torch

    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{name}: output {i} differs from the plain version")


def profile_loop(fn, frames: int) -> dict:
    """Kernel launches per frame, device ms and the device's busy share of
    one ``fn()`` under ``torch.profiler`` (copies and memsets are not
    launches; the profiler's own cost is in the wall time)."""
    import torch

    from rasr_tpu_torch.examples.profile_decode import busy_us

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [ev for ev in on_device if not ev.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("the profiler saw no kernel on the card")
    spans = [(ev.time_range.start, ev.time_range.end) for ev in on_device]
    return {"launches_per_frame": len(kernels) / frames,
            "device_ms": sum(ev.time_range.elapsed_us() for ev in on_device) / 1e3,
            "wall_ms": wall_us / 1e3, "busy_share": busy_us(spans) / wall_us}


def describe(prof: dict) -> str:
    return (f"{prof['launches_per_frame']:.2f} launches per frame, device {prof['device_ms']:.1f} "
            f"ms of {prof['wall_ms']:.1f} ms wall (busy {prof['busy_share']:.1%})")


class Stages:
    """Host-clock ms of named stages, each ending in a synchronize."""

    def __init__(self):
        self.ms = {}

    def __call__(self, name, fn):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    def __str__(self):
        return ", ".join(f"{k} {v:.1f} ms" for k, v in self.ms.items())


def check_stats(name, got, want, rtol) -> float:
    """Accumulated statistics (float64 numpy) within ``rtol`` of each entry
    plus ``rtol`` of the largest magnitude; returns the largest error
    relative to that magnitude."""
    import numpy as np

    scale = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got - want)
    if not np.isfinite(got).all() or bool((err > rtol * (np.abs(want) + scale)).any()):
        raise AssertionError(f"{name}: off by up to {err.max():.3e} (scale {scale:.3e})")
    return float(err.max() / scale)


def align_em_phase(s, dev, samples, lengths, rng, say, reset_counts, read_counts):
    """The classical training chain at the main path's width on 64 x 10 s:
    features (the MFCC kernel), flat-start labels, one EM step, a Viterbi
    realign (the GMM kernel), Baum-Welch posteriors, LDA; the card's
    alignments and statistics against the CPU's."""
    import numpy as np
    import torch

    from rasr_tpu_torch.align.aligner import (
        BatchAligner, _device_graphs, _gather_emissions, linear_segmentation,
    )
    from rasr_tpu_torch.align.graph import build_linear_graph
    from rasr_tpu_torch.models.hmm import HmmTopology
    from rasr_tpu_torch.models.scorer import GmmFeatureScorer
    from rasr_tpu_torch.ops.frontend import FeatureFrontend, FrontendConfig
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores
    from rasr_tpu_torch.ops.kernels.mfcc import mfcc_frames
    from rasr_tpu_torch.ops.viterbi import BIG, forward_backward, viterbi_align
    from rasr_tpu_torch.train import em, lda

    B = samples.shape[0]
    words = [lemma.primary_orth for lemma in s.lexicon.lemmata if not lemma.special]
    topo = HmmTopology(states_per_phone=3, silence_states=1)
    spliced_fe = FeatureFrontend(FrontendConfig(), splice_context=4, device=dev)
    M, K, D = s.mixtures.means.shape

    def chain(x, n, orths, st):
        """The chain on audio ``x`` with lengths ``n``, each stage timed."""
        out = {}
        f, nf = out["feats"], out["n"] = st("features", lambda: s.frontend(x, n))
        spliced = out["spliced"] = st("spliced features", lambda: spliced_fe(x, n))[0]
        graphs = out["graphs"] = st("graphs (host)", lambda: [
            build_linear_graph(o, s.lexicon, s.tying, topo) for o in orths])
        n_host = out["n_host"] = nf.cpu().numpy()
        labels = out["labels"] = st("linear segmentation (host)",
                                    lambda: linear_segmentation(graphs, n_host))
        acc = out["acc"] = st("EM accumulate", lambda: em.accumulate(
            em.GmmAccumulator.zeros(M, K, D), s.mixtures, f, labels))
        model = out["model"] = st("EM estimate (host)", lambda: em.estimate(acc, prev=s.mixtures))
        scorer = GmmFeatureScorer(model, device=dev)
        scores = out["scores"] = st("GMM scores", lambda: scorer(f))
        als = out["als"] = st("Viterbi align", lambda: BatchAligner(scorer).align_scores(
            scores, graphs, nf))
        out["total"], out["gamma"], _ = st("Baum-Welch gamma", lambda: BatchAligner(
            scorer, "baum-welch").gamma(f, graphs, nf))
        vlabels = out["vlabels"] = np.full(labels.shape, -1, np.int32)
        for i, a in enumerate(als):
            vlabels[i, : a.num_frames] = a.emission_ids
        scatter = out["scatter"] = st("LDA scatter", lambda: lda.accumulate_scatter(
            lda.ScatterAccumulator.zeros(M, spliced.shape[-1]), spliced, vlabels))
        out["proj"] = st("LDA estimate (host)", lambda: lda.estimate_lda(scatter, D))[0]
        return out

    # a small batch first: the first launch of each kernel and the first
    # calls of the host solvers are not the chain's steady cost
    chain(samples[:4, :32000], torch.full((4,), 32000, device=dev),
          [" ".join(rng.choice(words, size=2)) for _ in range(4)], Stages())
    orths = [" ".join(rng.choice(words, size=int(rng.integers(*ALIGN_WORDS)))) for _ in range(B)]
    st = Stages()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    out = chain(samples, lengths, orths, st)
    counts = read_counts("align-em path", gmm_scores, mfcc_frames)
    peak = torch.cuda.max_memory_allocated(dev)
    nf, n_host, graphs, scores = out["n"], out["n_host"], out["graphs"], out["scores"]
    als, total, gamma, acc = out["als"], out["total"], out["gamma"], out["acc"]
    T = int(n_host.max())
    states = [g.num_states for g in graphs]
    say(f"align-em B={B} x {T} frames, graphs of {min(states)}-{max(states)} states, "
        f"{acc.count.sum():.0f} frames accumulated (after a 4 x 2 s warm-up): {st}")
    realign_s = (st.ms["GMM scores"] + st.ms["Viterbi align"]) / 1e3
    say(f"align-em Viterbi realign (GMM kernel + DP + host alignments) "
        f"{B * AUDIO_S / realign_s:.1f} aligned audio-s/s; Baum-Welch "
        f"{B * AUDIO_S / (st.ms['Baum-Welch gamma'] / 1e3):.1f} audio-s/s; EM accumulate + "
        f"estimate {st.ms['EM accumulate'] + st.ms['EM estimate (host)']:.1f} ms per batch; "
        f"launches {counts}; peak device memory {peak / 2**30:.2f} GiB")
    # what came out: every utterance aligned, a model, an LDA; the Baum-Welch
    # posteriors of each frame sum to 1 up to the float32 rounding of the
    # two recursions, a random walk of T roundings of costs near the total:
    # |log sum| within OCC_SQRT_T_ULPS x sqrt(T) ulps of the largest total
    problems = []
    if not all(np.isfinite(a.score) and a.score < BIG / 2 for a in als):
        problems.append("an utterance did not align")
    ulp = float(np.spacing(np.float32(np.abs(total).max())))
    occ_err = float(np.abs(np.log(gamma.sum(-1)[:, :T])).max())
    if not (np.isfinite(total).all() and occ_err <= OCC_SQRT_T_ULPS * np.sqrt(T) * ulp):
        problems.append(f"Baum-Welch frame sums off 1 by {occ_err:.3e} in log")
    model, proj = out["model"], out["proj"]
    w = (model.weights * model.density_mask).sum(1)
    if not (np.allclose(w, 1.0, atol=1e-5) and np.isfinite(proj).all()
            and proj.shape == (out["spliced"].shape[-1], D)):
        problems.append("the estimated GMM or LDA is malformed")
    # the card's alignments and statistics against the CPU's, same inputs
    cpu_als = BatchAligner(None).align_scores(scores.cpu(), graphs, n_host)
    for a, b in zip(als, cpu_als):
        if not np.array_equal(a.state_indices, b.state_indices):
            problems.append(f"card vs cpu Viterbi states ({a.segment_name})")
        if abs(a.score - b.score) > ALIGN_RTOL * abs(b.score):
            problems.append(f"card vs cpu Viterbi score {a.score} vs {b.score}")
    nb = ALIGN_CPU_BW
    cpu_scores = scores[:nb].cpu()
    cpu_total, cpu_gamma, _ = BatchAligner(lambda _: cpu_scores, "baum-welch").gamma(
        None, graphs[:nb], n_host[:nb])
    S_nb = cpu_gamma.shape[-1]
    total_err = float(np.abs(total[:nb] - cpu_total).max() / np.abs(cpu_total).max())
    gamma_err = float(np.abs(gamma[:nb, :, :S_nb] - cpu_gamma).max())
    if total_err > ALIGN_RTOL or gamma_err > GAMMA_ULPS * ulp:
        problems.append(f"card vs cpu Baum-Welch: totals {total_err:.2e} relative, posteriors "
                        f"{gamma_err:.2e} (tolerance {GAMMA_ULPS * ulp:.2e})")
    errs = {}
    cpu_acc = em.accumulate(em.GmmAccumulator.zeros(M, K, D), s.mixtures, out["feats"].cpu(),
                            out["labels"])
    cpu_scatter = lda.accumulate_scatter(
        lda.ScatterAccumulator.zeros(M, out["spliced"].shape[-1]), out["spliced"].cpu(),
        out["vlabels"])
    for kind, got, want, fields in (("EM", acc, cpu_acc, ("count", "sum", "sumsq")),
                                    ("LDA", out["scatter"], cpu_scatter,
                                     ("class_count", "class_sum", "total_sqsum"))):
        for k in fields:
            try:
                errs[f"{kind} {k}"] = check_stats(f"{kind} {k} card vs cpu", getattr(got, k),
                                                  getattr(want, k), EM_RTOL)
            except AssertionError as exc:
                problems.append(str(exc))
    say(f"align-em card vs cpu: Viterbi states {'exact' if not problems else 'see below'} on "
        f"{B} utterances; Baum-Welch (first {nb}) totals within {total_err:.2e} relative, "
        f"posteriors max "
        f"abs err {gamma_err:.2e} (tolerance {GAMMA_ULPS} ulps of the largest total, "
        f"{GAMMA_ULPS * ulp:.2e}); frame sums within {occ_err:.2e} of 1 in log (bound "
        f"{OCC_SQRT_T_ULPS * np.sqrt(T) * ulp:.2e}); statistics within "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" of their largest entry (tolerance {EM_RTOL} of the entry + {EM_RTOL} of the "
        f"largest)")
    if problems:
        raise AssertionError("align-em: " + "; ".join(problems[:10]))
    # the DP loops alone, on the emissions of the graph states
    g = _device_graphs(graphs, dev)
    emis = _gather_emissions(scores, g[0])
    vit = profile_loop(lambda: viterbi_align(emis, *g[1:], nf), T)
    fb = profile_loop(lambda: forward_backward(emis, *g[1:], nf), T)
    say(f"align-em Viterbi loop (forward + backtrace, B={B} x {T} frames): {describe(vit)}")
    say(f"align-em forward-backward loop: {describe(fb)}")
    return counts, out["model"], graphs


def train_ce_phase(dev, rng, say, reset_counts, counted):
    """bench.py's BENCH_TRAIN=1 step through the port's bench entry, then
    the checks: one float32 step on the card == the CPU's, the bf16 loss
    falling, a mid-epoch resume bit-equal."""
    import numpy as np
    import torch

    from rasr_tpu_torch import bench
    from rasr_tpu_torch.models.nn import ConformerEncoderNet, FeedForwardNet, init_params
    from rasr_tpu_torch.synthetic import CONFORMER
    from rasr_tpu_torch.train.checkpoint import CheckpointManager
    from rasr_tpu_torch.train.nn_trainer import (
        FrameDataset, NnTrainer, SequenceTrainer, TrainConfig,
    )

    reset_counts()
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(io.StringIO()) as err:
        record = bench.run(dev, out=out, train=True)
    counts = {fn.__name__: fn.launches for fn in counted}
    for line in err.getvalue().splitlines():
        say(line)
    say(f"train-ce bench entry {time.time() - t0:.1f} s, launches {counts} (no GMM or MFCC on "
        f"this path): {out.getvalue().strip()}")
    if record["metric"] != "torch_train_mfu" or not 0 < record["value"] < 100:
        raise AssertionError(f"train-ce: {record}")

    # one float32 step of a small conformer, card vs CPU
    kw = dict(d_model=64, num_blocks=2, num_heads=4, conv_kernel=15)
    on_cpu = init_params(ConformerEncoderNet(40, 45, device="cpu", **kw), 2)
    on_card = ConformerEncoderNet(40, 45, device=dev, **kw)
    on_card.load_state_dict(on_cpu.state_dict())
    batch = (rng.normal(size=(4, 200, 45)).astype(np.float32),
             rng.integers(0, 40, size=(4, 200)).astype(np.int32), np.ones((4, 200), np.float32))
    for net, d in ((on_cpu, "cpu"), (on_card, dev)):
        SequenceTrainer(net, 40, TrainConfig(learning_rate=0.05))._update(
            *(torch.from_numpy(a).to(d) for a in batch))
    step_err = max(check_close(f"train-ce float32 step card vs cpu: {k}", v.cpu(),
                               on_cpu.state_dict()[k], TRAIN_F32_RTOL, TRAIN_F32_ATOL)
                   for k, v in on_card.state_dict().items())

    # the bf16 network at bench width learns a synthetic task
    net = init_params(ConformerEncoderNet(2000, 45, **CONFORMER, compute_dtype="bfloat16",
                                          device=dev), 1)
    trainer = SequenceTrainer(net, 2000, TrainConfig(optimizer="adam"))
    y = rng.integers(0, 2000, size=(16, 400))
    means = rng.normal(size=(2000, 45)).astype(np.float32)
    x = means[y] + 0.3 * rng.normal(size=(16, 400, 45)).astype(np.float32)
    task = [torch.from_numpy(a).to(dev) for a in (x, y.astype(np.int32),
                                                  np.ones((16, 400), np.float32))]
    losses = [float(trainer._update(*task)[0]) for _ in range(BF16_STEPS)]
    if not (np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3]) - BF16_FALL):
        raise AssertionError(f"train-ce: the bf16 loss did not fall: {losses}")
    del net, trainer, task

    # a run resumed mid-epoch from a checkpoint ends bit-equal
    feats = rng.normal(size=(8192, 45)).astype(np.float32)
    ds = FrameDataset(feats, rng.integers(0, 2000, size=8192).astype(np.int32))
    ffnn = FeedForwardNet(2000, 45, hidden=(512, 512), device=dev)
    cfg = TrainConfig(batch_size=256, epochs=2, learning_rate=0.05)
    straight, _ = NnTrainer(ffnn, 2000, cfg).train(ds)
    with tempfile.TemporaryDirectory() as ckdir:
        ck = CheckpointManager(ckdir, max_to_keep=100)
        NnTrainer(ffnn, 2000, cfg).train(ds, ckpt=ck, ckpt_every=10)
        for step in ck.all_steps():  # the job died after step 45, in epoch 1
            if step > 45:
                for suffix in (".pt", ".json"):
                    os.remove(os.path.join(ckdir, f"ckpt_{step:08d}{suffix}"))
        cut = ck.latest_step()
        resumed, _ = NnTrainer(ffnn, 2000, cfg).train(ds, ckpt=ck, resume=True)
    if cut != 40 or not all(torch.equal(straight[k], resumed[k]) for k in straight):
        raise AssertionError("train-ce: the resumed run is not bit-equal to the straight one")
    say(f"train-ce checks: float32 conformer step card vs cpu max abs err {step_err:.2e} "
        f"(tolerance {TRAIN_F32_ATOL} + {TRAIN_F32_RTOL} x value); bf16 loss at bench width over "
        f"{BF16_STEPS} Adam steps {losses[0]:.3f} -> {losses[-1]:.3f}; FFNN resumed at step 40 of "
        f"64 (epoch 1, minibatch 8) bit-equal to the straight run")
    return record, counts


def train_lfmmi_phase(s, dev, rng, say, reset_counts, counted):
    """LF-MMI and sMBR steps of bench.py's conformer at B=16 x 400 over a
    phone-bigram denominator of the main path's 40 phones (3 states each,
    the main path's classes without contexts; numerator graphs of 3-6
    words without optional silence); the loss and emission gradient of
    B=2 on the card against the CPU's."""
    import numpy as np
    import torch

    from rasr_tpu_torch.align.aligner import linear_segmentation
    from rasr_tpu_torch.align.graph import build_linear_graph
    from rasr_tpu_torch.models.allophone import Allophone, AllophoneState
    from rasr_tpu_torch.models.hmm import HmmTopology
    from rasr_tpu_torch.models.nn import ConformerEncoderNet, init_params
    from rasr_tpu_torch.synthetic import CONFORMER
    from rasr_tpu_torch.train import lfmmi
    from rasr_tpu_torch.train.nn_trainer import LfMmiSequenceTrainer, TrainConfig

    B, T, C = 16, 400, s.scorer.num_classes

    class ContextFree:
        """The main path's tying without contexts: the classes of the
        denominator's phone states, so every numerator path is one of the
        denominator's."""

        num_classes = C

        def classify(self, state):
            return s.tying.classify(AllophoneState(Allophone(state.allophone.center),
                                                   state.state))

    tying = ContextFree()
    phones = [p for p in s.lexicon.phonemes if not p.context_independent]
    den = lfmmi.build_phone_bigram_den(
        len(phones), 3,
        lambda p, q: tying.classify(AllophoneState(Allophone(phones[p].id), q)),
        np.full((len(phones),) * 2, np.log(len(phones)), np.float32), device=dev)
    words = [lemma.primary_orth for lemma in s.lexicon.lemmata if not lemma.special]
    topo = HmmTopology(states_per_phone=3, silence_states=1)
    graphs = [build_linear_graph(" ".join(rng.choice(words, size=int(rng.integers(3, 7)))),
                                 s.lexicon, tying, topo, optional_silence=False)
              for _ in range(B)]
    n = np.full(B, T)
    labels = linear_segmentation(graphs, n)
    x = rng.normal(size=(B, T, 45)).astype(np.float32)
    net = init_params(ConformerEncoderNet(C, 45, **CONFORMER, compute_dtype="bfloat16",
                                          device=dev), 3)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    rows = {}
    for crit in ("mmi", "smbr"):
        tr = LfMmiSequenceTrainer(net, C, den, TrainConfig(), criterion=crit, ce_weight=0.1)
        batch = (*(torch.from_numpy(a).to(dev) for a in (x, labels, n)),
                 *tr.padded_graphs(graphs, B))
        loss = tr._mmi_update(*batch)[0]  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LFMMI_STEPS):
            loss, obj = tr._mmi_update(*batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / LFMMI_STEPS
        if not (np.isfinite(float(loss)) and np.isfinite(float(obj))):
            raise AssertionError(f"train-lfmmi {crit}: non-finite loss {float(loss)}")
        prof = profile_loop(lambda: tr._mmi_update(*batch), T)
        rows[crit] = step_ms
        say(f"train-lfmmi {crit} B={B} x {T} (d{CONFORMER['d_model']} x "
            f"{CONFORMER['num_blocks']} bf16, den {den.num_states} states, ce anchor 0.1): "
            f"{step_ms:.1f} ms per step over {LFMMI_STEPS} steps, {B * T / step_ms * 1e3:.0f} "
            f"frames/s, loss {float(loss):.4f}, {crit}/frame {float(obj):.4f}; one step "
            f"profiled: {describe(prof)}")
    counts = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        emis = -torch.log_softmax(net(torch.from_numpy(x[:2]).to(dev),
                                      lengths=torch.from_numpy(n[:2]).to(dev)), dim=-1)
    den_prof = profile_loop(lambda: lfmmi.dense_forward(emis, den, torch.from_numpy(n[:2]).to(dev)),
                            T)
    g2 = [a[:2] for a in tr.padded_graphs(graphs, B)]
    out = {}
    for d in (dev, "cpu"):
        e = emis.to(d)
        nd = torch.from_numpy(n[:2]).to(d)
        fsa = den.to(d)
        loss, grad = lfmmi.lfmmi_grad_emissions(e, fsa, nd, *(a.to(d) for a in g2[1:]), g2[0].to(d))
        et = e.clone().requires_grad_(True)
        acc = lfmmi.expected_accuracy(et, fsa, nd, torch.from_numpy(labels[:2]).to(d))
        acc.sum().backward()
        out[str(d)] = [t.detach().cpu() for t in (loss, grad, acc, et.grad)]
    errs = [check_close(f"train-lfmmi B=2 {name} card vs cpu", a, b, LFMMI_RTOL,
                        LFMMI_RTOL * float(b.abs().max()))
            for name, a, b in zip(("mmi loss", "mmi emission gradient", "smbr objective",
                                   "smbr emission gradient"), out[str(dev)], out["cpu"])]
    say(f"train-lfmmi card == cpu on B=2 x {T}: mmi loss, emission gradient, sMBR objective "
        f"and its gradient within {LFMMI_RTOL} relative (max abs errs "
        f"{', '.join(f'{e:.2e}' for e in errs)}); denominator forward alone (B=2): "
        f"{describe(den_prof)}; launches {counts}; peak device memory {peak / 2**30:.2f} GiB")
    return rows, counts


def fmllr_phase(s, dev, corpus, batch, feats, n_frames, base, say, reset_counts, read_counts):
    """Per-speaker fMLLR from a Viterbi alignment of the recognizer corpus,
    then the recognizer with those transforms, and with identity
    transforms (the words of the plain run)."""
    import numpy as np
    import torch

    from rasr_tpu_torch.align.aligner import BatchAligner
    from rasr_tpu_torch.align.graph import build_linear_graph
    from rasr_tpu_torch.models.hmm import HmmTopology
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores
    from rasr_tpu_torch.ops.kernels.mfcc import mfcc_frames
    from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
    from rasr_tpu_torch.pipeline.visitor import CorpusVisitor
    from rasr_tpu_torch.train.fmllr import (
        FmllrModelTensors, estimate_fmllr, fmllr_auxiliary, fmllr_stats,
    )

    topo = HmmTopology(states_per_phone=3, silence_states=1)
    st = Stages()
    graphs = st("graphs (host)", lambda: [build_linear_graph(seg.orth, s.lexicon, s.tying, topo)
                                          for seg in batch.segments])
    als = st("Viterbi align", lambda: BatchAligner(s.scorer).align(feats, graphs, n_frames))
    mt = FmllrModelTensors.from_mixture_set(s.mixtures, device=dev)
    speakers = sorted({seg.speaker for seg in batch.segments})[:FMLLR_SPEAKERS]
    D = feats.shape[-1]
    ident = np.hstack([np.eye(D), np.zeros((D, 1))])
    table, frames = {}, 0
    for spk in speakers:
        rows = [i for i, seg in enumerate(batch.segments) if seg.speaker == spk]
        x = torch.cat([feats[i, : als[i].num_frames] for i in rows])
        mix = np.concatenate([als[i].emission_ids for i in rows])
        G, k, beta = st(f"stats {spk}", lambda: fmllr_stats(x, mix, mt))
        W = st(f"estimate {spk} (host)", lambda: estimate_fmllr(G, k, beta))
        if not (np.isfinite(W).all() and fmllr_auxiliary(G, k, beta, W)
                >= fmllr_auxiliary(G, k, beta, ident) - 1e-6 * abs(fmllr_auxiliary(G, k, beta,
                                                                                   ident))):
            raise AssertionError(f"fmllr: the transform of {spk} lowers the auxiliary")
        table[spk] = W
        frames += x.shape[0]
    # the statistics of the last speaker on the CPU
    Gc, kc, bc = fmllr_stats(x.cpu(), mix, s.mixtures, device="cpu")
    stat_err = max(check_stats("fmllr G card vs cpu", G, Gc, EM_RTOL),
                   check_stats("fmllr k card vs cpu", k, kc, EM_RTOL))
    say(f"fmllr {len(speakers)} speakers, {frames} frames: {st}; statistics card vs cpu within "
        f"{stat_err:.2e} of their largest entry")
    runs = {}
    for label, tab in (("fMLLR", table), ("identity", {spk: ident for spk in speakers})):
        rec = OfflineRecognizer(s.frontend, s.scorer, s.decoder, feature_transforms=tab)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        runs[label] = {r.segment_name: r for r in rec.run(CorpusVisitor(corpus,
                                                                       batch_size=len(base)))}
        wall = time.time() - t0
        counts = read_counts(f"fmllr recognizer path ({label})", gmm_scores, mfcc_frames)
        say(f"fmllr recognizer ({label} transforms on {len(speakers)} speakers): "
            f"{float(batch.lengths.sum()) / 16000 / wall:.1f} audio-s/s; launches {counts}")
    if [r.words for r in runs["identity"].values()] != [base[k].words for k in runs["identity"]]:
        raise AssertionError("fmllr: identity transforms decode other words than no transforms")
    adapted = {seg.full_name for seg in batch.segments if seg.speaker in table}
    changed = sum(runs["fMLLR"][k].words != base[k].words for k in adapted)
    say(f"fmllr: identity transforms == no transforms on {len(base)} segments; the fMLLR "
        f"transforms changed the words of {changed} of the {len(adapted)} adapted segments")
    return counts


def rnn_fusion_phase(s, dev, samples, lengths, corpus, batch, feats, n_frames, main_rate, rng,
                     say, reset_counts, read_counts):
    """The neural LM and the second pass at the main path's width: an RNN
    LM trained on the card, the fused decode from audio (B=64 x 10 s) under
    the production beam beside the n-gram-only decoder, the fused decode on
    the card against the CPU, the fused stream with its bounded pool, the
    recognizer with lattices and n-best lists, RNN rescoring and confusion
    networks of its lattices, and one MMI EBW update from them (the card's
    accumulators against the CPU's)."""
    import numpy as np
    import torch

    from rasr_tpu_torch.align.aligner import BatchAligner
    from rasr_tpu_torch.align.graph import build_linear_graph
    from rasr_tpu_torch.lattice import flf
    from rasr_tpu_torch.lattice.lattice import decoder_lattice
    from rasr_tpu_torch.models.hmm import HmmTopology, TransitionModel
    from rasr_tpu_torch.models.lm.rnn import RnnLm
    from rasr_tpu_torch.models.scorer import GmmFeatureScorer
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores
    from rasr_tpu_torch.ops.kernels.mfcc import mfcc_frames
    from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
    from rasr_tpu_torch.pipeline.visitor import CorpusVisitor
    from rasr_tpu_torch.search.decoder import TreeDecoder
    from rasr_tpu_torch.search.rnn_fusion import build_rnn_fusion, cell_step, word_scores
    from rasr_tpu_torch.search.streaming import StreamingDecoder
    from rasr_tpu_torch.device import cuda_ms
    from rasr_tpu_torch.train import discriminative

    # ---- the RNN LM, trained on the card
    words = [lemma.primary_orth for lemma in s.lexicon.lemmata if not lemma.special]
    text = [list(rng.choice(words, size=RNN_SENTENCE_WORDS)) for _ in range(RNN_SENTENCES)]
    unseen = len(set(words) - {w for sent in text for w in sent})
    # a one-epoch warm-up on a slice of the text: the first launches of the
    # training's kernels (cuBLAS handles, runtime-compiled elementwise ones)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    RnnLm.train_from_text(text[:100], embed_dim=RNN_EMBED, hidden_dim=RNN_HIDDEN, epochs=1,
                          device=dev)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rnn = RnnLm.train_from_text(text, embed_dim=RNN_EMBED, hidden_dim=RNN_HIDDEN,
                                epochs=RNN_EPOCHS, device=dev)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    losses = rnn.train_losses
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"rnn training: the loss did not fall: {losses}")
    V = len(rnn.vocab)
    say(f"rnn lm E={RNN_EMBED} H={RNN_HIDDEN} V={V} ({unseen} of {len(words)} words unseen) on "
        f"{RNN_SENTENCES} x {RNN_SENTENCE_WORDS} words: {RNN_EPOCHS} full-batch Adam epochs in "
        f"{train_ms:.1f} ms ({train_ms / RNN_EPOCHS:.1f} ms per epoch, set-up included; a "
        f"1-epoch warm-up on 100 sentences {warm_ms:.1f} ms before it); loss "
        f"{' '.join(f'{x:.3f}' for x in losses)}")

    # ---- the fused decode from audio, beside the n-gram-only main path
    fusion = build_rnn_fusion(rnn, s.lm.vocab, weight=RNN_WEIGHT, device=dev)
    oov = sum(rnn.vocab.get(w) is None for w in words)
    dec = TreeDecoder(s.tree, s.decoder.lm, s.beam, rnn_fusion=fusion, device=dev,
                      tables=s.decoder.tables)
    B, K, R, H = samples.shape[0], dec.cfg.max_hyps, dec.cfg.word_end_limit, fusion.hidden

    def run(x, n):
        st = Stages()
        f, nf = st("frontend", lambda: s.frontend(x, n))
        e = st("scorer", lambda: s.scorer(f))
        handle = st("decode", lambda: dec.decode_scores_device(e, nf))
        return e, nf, handle, st, dec.results_from_device(handle)

    run(samples[:, :16000], torch.full_like(lengths, 16000))  # warm-up on 1 s, as slice A's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    e, nf, handle, st, results = run(samples, lengths)
    wall = time.perf_counter() - t0
    counts = read_counts("rnn-fusion path", gmm_scores, mfcc_frames)
    peak = torch.cuda.max_memory_allocated(dev)
    T = e.shape[1]
    if len(results) != B or not all(np.isfinite(r.score) and r.words for r in results):
        raise AssertionError("rnn-fusion decode: an empty or non-finite result")
    pool_bytes = 2 * handle.finals.cs.numel() * 4
    rate = B * AUDIO_S / wall
    say(f"rnn-fusion path B={B} x {AUDIO_S:g} s ({T} frames, {oov} n-gram words unknown to the "
        f"RNN LM): {st}; {rate:.1f} audio-s/s against the n-gram-only main path's "
        f"{main_rate:.1f} ({rate / main_rate:.2f}x); state pools {pool_bytes / 2**30:.2f} GiB "
        f"(2 x {B} x {R * T + 1} x {H} float32); peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {counts}")
    say(f"rnn-fusion sample: {results[0].orth[:80]!r} score {results[0].score:.3f}")
    del handle
    # the two decoders on these emissions in turns (n-gram, fused, fused,
    # n-gram): the host's speed drifts within a call, so one batch of each
    # at different times compares the host as much as the decoders
    turns = {"n-gram only": [], "rnn fusion": []}
    for label, d in (("n-gram only", s.decoder), ("rnn fusion", dec), ("rnn fusion", dec),
                     ("n-gram only", s.decoder)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.results_from_device(d.decode_scores_device(e, nf))
        turns[label].append(B * AUDIO_S / (time.perf_counter() - t0))
    say("decode alone in turns on the batch's emissions (audio-s/s): " + "; ".join(
        f"{k} {' / '.join(f'{x:.1f}' for x in v)}" for k, v in turns.items())
        + f"; fused / n-gram {sum(turns['rnn fusion']) / sum(turns['n-gram only']):.2f}")
    frames = torch.full((B,), PROFILE_FRAMES, dtype=torch.int64, device=dev)
    for label, d in (("n-gram only", s.decoder), ("rnn fusion", dec)):
        prof = profile_loop(lambda: d.decode_scores_device(e[:, :PROFILE_FRAMES], frames),
                            PROFILE_FRAMES)
        say(f"decode frame loop ({label}, first {PROFILE_FRAMES} frames): {describe(prof)}; per "
            f"frame {prof['device_ms'] / PROFILE_FRAMES:.3f} device ms of "
            f"{prof['wall_ms'] / PROFILE_FRAMES:.3f} wall ms")
    # the word-end update's two products at its shapes, against their bound
    h = torch.randn((B, R, H), device=dev)
    c = torch.randn((B, R, H), device=dev)
    x = fusion.emb[torch.randint(0, V, (B, R), device=dev)]
    wid = torch.randint(0, V, (B, R), device=dev)
    ws_ms = cuda_ms(lambda: word_scores(fusion, h, wid), 20)
    cs_ms = cuda_ms(lambda: cell_step(fusion, x, c, h), 20)
    E = fusion.emb.shape[1]
    ws_bound = bound(2.0 * B * R * H * V, 4.0 * (B * R * H + H * V + V + 2 * B * R))
    cs_bound = bound(2.0 * B * R * (E + H) * 4 * H,
                     4.0 * (B * R * (E + 2 * H) + (E + H + 1) * 4 * H + 2 * B * R * H))
    say(f"word_scores [{B}, {R}, {H}] x [{H}, {V}] per frame: {ws_ms:.4f} ms (CUDA events), "
        f"bound {ws_bound[0]:.4f} ms ({ws_bound[1]}), logits {B * R * V * 4 / 1e6:.1f} MB; "
        f"cell_step {cs_ms:.4f} ms, bound {cs_bound[0]:.4f} ms ({cs_bound[1]})")

    # ---- card == CPU on B=4 x 3 s with the same tables
    small = int(3.0 * 16000)
    f4, nf4 = s.frontend(samples[:4, :small], torch.full((4,), small, device=dev))
    e4 = s.scorer(f4)
    dec_cpu = TreeDecoder(s.tree, s.decoder.lm.to("cpu"), s.beam, rnn_fusion=fusion.to("cpu"),
                          device="cpu", tables=s.decoder.tables.to("cpu"))
    a = dec.decode_scores(e4, nf4)
    b = dec_cpu.decode_scores(e4.cpu(), nf4.cpu())
    for x_, y_ in zip(a, b):
        if x_.words != y_.words or abs(x_.score - y_.score) > DECODE_RTOL * max(1.0, abs(y_.score)):
            raise AssertionError(f"rnn fusion cuda vs cpu: {x_.words} {x_.score} vs "
                                 f"{y_.words} {y_.score}")
    say(f"cuda == cpu fused decode on B=4 x 3 s: {[r.orth[:30] for r in a]}")

    # ---- the fused stream over the timed batch's emissions
    offline = results
    sd = StreamingDecoder(dec).restart(B, nf)
    t0 = time.perf_counter()
    for lo in range(0, T, RNN_STREAM_BLOCK):
        block = e[:, lo: lo + RNN_STREAM_BLOCK]
        sd.feed(block)
        rows = sd._carry.cs.shape[1]
        if rows != 2 * K + R * block.shape[1]:
            raise AssertionError(f"rnn-fusion stream: {rows} pool rows after a feed of "
                                 f"{block.shape[1]} frames")
    streamed = sd.finalize()
    stream_s = time.perf_counter() - t0
    if [r.words for r in streamed] != [r.words for r in offline]:
        raise AssertionError("rnn-fusion stream: other words than the offline decode")
    say(f"rnn-fusion stream in blocks of {RNN_STREAM_BLOCK}: {B * AUDIO_S / stream_s:.1f} "
        f"audio-s/s; pool {2 * K + R * RNN_STREAM_BLOCK} rows per utterance after each full "
        f"feed ({2 * 2 * K * B * H * 4 / 2**30 + 2 * R * RNN_STREAM_BLOCK * B * H * 4 / 2**30:.3f}"
        f" GiB); streamed == offline")
    del sd, e

    # ---- the recognizer, n-gram only and fused: lattices and n-best lists.
    # A list exists for each lattice with final nodes; it must be flf.n_best
    # of the archived lattice (which ranks paths by their cost before the
    # final score, as the reference's does: rank 0 need not be the
    # cheapest). The cheapest path of each lattice is checked against the
    # best path where that holds a word: the same words on the n-gram
    # lattices; under fusion a lattice node merges records of one (frame,
    # n-gram state) whatever their RNN histories, so a path may join arcs
    # scored in different histories and the cheapest one is the best path
    # or a join no dearer than it (within float32 rounding).
    from rasr_tpu_torch.lattice.lattice import Lattice
    from rasr_tpu_torch.utils.archive import FileArchive

    def orths(lat, path):
        return [lat.lemma_orths[a.lemma] for a in path
                if a.lemma >= 0 and not lat.lemma_orths[a.lemma].startswith("[")]

    for label, d in (("n-gram only", s.decoder), ("rnn fusion", dec)):
        with tempfile.TemporaryDirectory() as tmp:
            nbest_path, lat_path = os.path.join(tmp, "nbest"), os.path.join(tmp, "lat")
            rec = OfflineRecognizer(s.frontend, s.scorer, d, lattice_archive=lat_path,
                                    nbest_file=nbest_path, nbest=RNN_NBEST)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            rec_results = rec.run(CorpusVisitor(corpus, batch_size=len(batch.names)))
            wall = time.perf_counter() - t0
            rec_counts = read_counts(f"{label} recognizer with n-best lists", gmm_scores,
                                     mfcc_frames)
            lists = {}
            with open(nbest_path) as fh:
                for line in fh:
                    seg, rank, score, *hyp = line.split()
                    lists.setdefault(seg, []).append((int(rank), float(score), hyp))
            with FileArchive(lat_path, "r") as ar:
                lats = {seg: Lattice.unpack(ar.read(seg)) for seg in lists}
        same = cheaper = 0
        for r in rec_results:
            if r.segment_name not in lists:
                continue
            lat, got = lats[r.segment_name], lists[r.segment_name]
            want = flf.n_best(lat, RNN_NBEST)
            if [(k, h) for k, _, h in got] != [(k, orths(lat, p)) for k, (_, p) in
                                               enumerate(want)] or any(
                    abs(sc - c) > 1e-3 + 1e-6 * abs(c) for (_, sc, _), (c, _) in zip(got, want)):
                raise AssertionError(f"{label} recognizer: the n-best list of {r.segment_name} "
                                     f"is not flf.n_best of its lattice")
            if not r.words:
                continue
            cost, path = flf.best_path(lat)
            if orths(lat, path) == r.words:
                same += 1
            elif d is dec and cost < r.score + 1e-5 * abs(r.score):
                cheaper += 1
            else:
                raise AssertionError(f"{label} recognizer: the cheapest path of the lattice of "
                                     f"{r.segment_name} ({cost}) is not the best path "
                                     f"({r.score})")
        if not same:
            raise AssertionError(f"{label} recognizer: no lattice holds its best path")
        say(f"{label} recognizer: {len(rec_results)} segments, "
            f"{float(batch.lengths.sum()) / 16000 / wall:.1f} audio-s/s with lattices and "
            f"{RNN_NBEST}-best lists ({sum(map(len, lists.values()))} lines, each list "
            f"flf.n_best of its lattice); the lattice's cheapest path is the best path on {same}"
            f" segments, a join of histories no dearer on {cheaper}; launches {rec_counts}")

    # ---- the second pass: RNN rescoring and confusion networks
    handle = dec.decode_scores_device(s.scorer(feats), n_frames)
    lats = [decoder_lattice(handle, s.tree.lemmas, b) for b in range(len(batch.names))]

    def paths(lat):
        count = np.zeros(lat.num_nodes)
        count[0] = 1.0
        out = lat.out_arcs()
        for node in lat.topological_order():
            for ai in out[node]:
                count[lat.arcs[ai].to_node] += count[node]
        return sum(count[n] for n in lat.final_scores)

    npaths = [paths(lat) for lat in lats]
    picked = sorted((i for i in range(len(lats)) if npaths[i] > 1), key=lambda i: npaths[i])
    picked = picked[:RNN_LATTICES]
    if len(picked) < RNN_LATTICES:
        raise AssertionError("rnn-fusion: too few lattices with more than one path")
    synt = {i: rnn.vocab.get(o) for i, o in enumerate(lats[0].lemma_orths)}
    t0 = time.perf_counter()
    rescored = [flf.rescore_lm(lats[i], rnn, synt) for i in picked]
    rescore_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cns = [flf.cn_decode(flf.confusion_network(lat)) for lat in rescored]
    cn_ms = (time.perf_counter() - t0) * 1e3
    say(f"rnn rescoring of {len(picked)} lattices ({[int(npaths[i]) for i in picked]} paths, "
        f"{[len(lats[i].arcs) for i in picked]} arcs -> {[len(x.arcs) for x in rescored]}): "
        f"{rescore_ms:.1f} ms ({len(rnn._cache)} RNN states cached); their confusion networks "
        f"{cn_ms:.1f} ms: {[' '.join(w)[:30] for w in cns]}")

    # ---- one MMI EBW update of the main path's GMMs from those lattices
    topo = HmmTopology(states_per_phone=3, silence_states=1)
    trans = TransitionModel()
    M, Kd, D = s.mixtures.means.shape
    cpu_scorer = GmmFeatureScorer(s.mixtures, device="cpu")
    graphs = [build_linear_graph(batch.segments[i].orth, s.lexicon, s.tying, topo)
              for i in picked]
    accs = {}
    for label, scorer, device in (("card", s.scorer, dev), ("cpu", cpu_scorer, "cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_ = feats[picked].to(device)
        n_ = n_frames[picked].to(device)
        aligner = BatchAligner(scorer)
        als = aligner.align(x_, graphs, n_)
        labels = np.full(x_.shape[:2], -1, np.int32)
        for j, al in enumerate(als):
            labels[j, : al.num_frames] = al.emission_ids
        acc = discriminative.MmiAccumulators.zeros(M, Kd, D)
        discriminative.accumulate_numerator(acc, s.mixtures, x_, labels, device=device)
        for j, i in enumerate(picked):
            discriminative.accumulate_denominator_from_lattice(
                acc, s.mixtures, x_[j, : int(n_[j])].cpu().numpy(), lats[i], aligner,
                s.lexicon, s.tying, topo, trans)
        accs[label] = acc, (time.perf_counter() - t0) * 1e3
    (acc, acc_ms), (acc_cpu, acc_cpu_ms) = accs["card"], accs["cpu"]
    err = 0.0
    for part in ("num", "den"):
        for stat in ("count", "sum", "sumsq"):
            got, want = getattr(getattr(acc, part), stat), getattr(getattr(acc_cpu, part), stat)
            scale = max(float(np.abs(want).max()), 1e-30)
            e_ = float(np.abs(got - want).max()) / scale
            if not np.isfinite(got).all() or e_ > 1e-4:
                raise AssertionError(f"mmi {part}.{stat}: card vs cpu off by {e_:.2e} of the "
                                     f"largest entry")
            err = max(err, e_)
    t0 = time.perf_counter()
    updated = discriminative.ebw_update(s.mixtures, acc)
    ebw_ms = (time.perf_counter() - t0) * 1e3
    moved = float(np.abs(updated.means - s.mixtures.means).max())
    if not (np.isfinite(updated.means).all() and (updated.variances > 0).all()):
        raise AssertionError("mmi: the EBW update is not a valid mixture set")
    say(f"mmi on {len(picked)} lattices: accumulators card {acc_ms:.1f} ms, cpu "
        f"{acc_cpu_ms:.1f} ms, card == cpu within {err:.2e} of the largest entry "
        f"(num count {acc.num.count.sum():.1f}, den count {acc.den.count.sum():.1f}); EBW "
        f"update {ebw_ms:.1f} ms (host), means moved up to {moved:.3f}")
    return counts


def frontend_ext_phase(s, dev, samples, lengths, em_model, graphs, say, reset_counts,
                       read_counts):
    """The other front ends at the bench batch's width: MFCC with energy,
    sliding CMVN, deltas and VTLN (51 dimensions) through the MFCC kernel,
    scored by the bench GMMs drawn at 51 dimensions and decoded under the
    production beam; the gammatone frontend; the VTLN grid search over the
    align-em path's EM model. Each against the CPU. Returns the MFCC
    kernel's largest error on the path's operands and the launch counts."""
    import numpy as np
    import torch

    from rasr_tpu_torch.align.aligner import BatchAligner
    from rasr_tpu_torch.device import cuda_ms
    from rasr_tpu_torch.models.lm.ngram import compile_ngram
    from rasr_tpu_torch.models.scorer import GmmFeatureScorer
    from rasr_tpu_torch.ops.frontend import (
        FeatureFrontend, FrontendConfig, frame_signal, num_frames, preemphasize,
    )
    from rasr_tpu_torch.ops.gammatone import (
        GammatoneConfig, GammatoneFrontend, piecewise_linear_warp,
    )
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores
    from rasr_tpu_torch.ops.kernels.mfcc import mfcc_frames, mfcc_frames_plain
    from rasr_tpu_torch.search.decoder import TreeDecoder
    from rasr_tpu_torch.synthetic import build_setup
    from rasr_tpu_torch.train.vtln import estimate_warping_factor

    B, S = samples.shape
    cfg = FrontendConfig(append_energy=True, normalize="sliding", norm_window=300)
    kw = dict(delta_order=2, vtln_warp=piecewise_linear_warp(cfg.num_bins, VTLN_ALPHA))
    t0 = time.time()
    s51 = build_setup(feat_dim=51, device=dev)
    fe = FeatureFrontend(cfg, device=dev, **kw)
    if fe.output_dim != 51 or s51.scorer.tensors.dim != 51:
        raise AssertionError(f"frontend-ext: {fe.output_dim} dims for a "
                             f"{s51.scorer.tensors.dim}-dim GMM")
    say(f"frontend-ext setup {time.time() - t0:.1f} s (the bench GMMs at 51 dims, the same "
        f"network); mel operand {tuple(fe.kmel.shape)} (the energy band after the VTLN "
        f"fold), DCT {tuple(fe.kdct.shape)}")

    # the kernel on the path's operands, against its plain version
    T = num_frames(S, cfg)
    frames = frame_signal(preemphasize(samples, cfg.preemphasis), T, cfg)
    args = (frames, fe.cosw, fe.sinw, fe.kmel, fe.kdct, cfg.log_floor)
    before = mfcc_frames.launches
    got = mfcc_frames(*args, fe.basis)
    torch.cuda.synchronize()
    if mfcc_frames.launches <= before:
        raise AssertionError("mfcc_frames did not launch its kernel")
    err = check_close(f"mfcc with energy under VTLN {VTLN_ALPHA}", got,
                      mfcc_frames_plain(*args), MFCC_RTOL, MFCC_ATOL)
    ms = cuda_ms(lambda: mfcc_frames(*args, fe.basis), 10)
    plain_ms = cuda_ms(lambda: mfcc_frames_plain(*args), 10)
    say(f"mfcc_frames with the energy column (21 bands, 17 outputs) N={B * T}: kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, max abs err {err:.3e} (energy column "
        f"{float((got[..., 16] - mfcc_frames_plain(*args)[..., 16]).abs().max()):.3e})")
    del got, frames

    def run(x, n):
        t_a = time.time()
        f, nf = fe(x, n)
        torch.cuda.synchronize()
        t_b = time.time()
        e = s51.scorer(f)
        torch.cuda.synchronize()
        t_c = time.time()
        res = s51.decoder.results_from_device(s51.decoder.decode_scores_device(e, nf))
        return f, e, nf, res, np.array([t_b - t_a, t_c - t_b, time.time() - t_c])

    run(samples[:, :16000], torch.full_like(lengths, 16000))  # warm-up on 1 s
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    f, e, nf, results, dt = run(samples, lengths)
    counts = read_counts("frontend-ext path", gmm_scores, mfcc_frames)
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(f.shape) != (B, T, 51) or not bool(torch.isfinite(f).all()):
        raise AssertionError(f"frontend-ext features: shape {tuple(f.shape)} or non-finite")
    if tuple(e.shape) != (B, T, s51.scorer.num_classes) or not bool(torch.isfinite(e).all()):
        raise AssertionError(f"frontend-ext emissions: shape {tuple(e.shape)} or non-finite")
    if not all(np.isfinite(r.score) and r.words for r in results):
        raise AssertionError("frontend-ext decode produced an empty or non-finite result")
    say(f"frontend-ext path B={B} x {AUDIO_S:g} s ({T} frames, 51 dims): frontend "
        f"{dt[0] * 1e3:.1f} ms, scorer {dt[1] * 1e3:.1f} ms, decode {dt[2] * 1e3:.1f} ms; "
        f"{B * AUDIO_S / dt.sum():.1f} audio-s/s; launches {counts}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    say(f"frontend-ext sample: {results[0].orth[:80]!r} score {results[0].score:.3f}")
    del f, e, results

    # card == CPU: features and the decode of B=2 x 3 s
    small = int(3.0 * 16000)
    x2, n2 = samples[:2, :small], torch.full((2,), small, device=dev)
    f2, nf2 = fe(x2, n2)
    f2c, _ = FeatureFrontend(cfg, device="cpu", **kw)(x2.cpu(), n2.cpu())
    feat_err = check_close("frontend-ext features cuda vs cpu", f2.cpu(), f2c, FEAT_EXT_RTOL,
                           FEAT_EXT_ATOL)
    e2 = s51.scorer(f2)
    on_cpu = TreeDecoder(s51.tree, compile_ngram(s51.lm), s51.beam, device="cpu")
    a, b = s51.decoder.decode_scores(e2, nf2), on_cpu.decode_scores(e2.cpu(), nf2.cpu())
    for x, y in zip(a, b):
        if x.words != y.words or abs(x.score - y.score) > DECODE_RTOL * max(1.0, abs(y.score)):
            raise AssertionError(f"cuda vs cpu decode (frontend-ext): {x.words} {x.score} vs "
                                 f"{y.words} {y.score}")
    say(f"frontend-ext card vs cpu on B=2 x 3 s: features max abs err {feat_err:.3e} "
        f"(tolerance {FEAT_EXT_ATOL} + {FEAT_EXT_RTOL} x value), decode equal: "
        f"{[r.orth[:40] for r in a]}")

    # the gammatone frontend on the bench batch (no kernel: cuDNN
    # convolutions in float32); its device time beside its bound
    gcfg = GammatoneConfig()
    gt = GammatoneFrontend(gcfg, device=dev)
    gt(samples[:, :16000], torch.full_like(lengths, 16000))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    g, gn = gt(samples, lengths)
    torch.cuda.synchronize()
    gt_host_ms = (time.perf_counter() - t0) * 1e3
    gt_counts = {fn.__name__: fn.launches for fn in (gmm_scores, mfcc_frames)}
    gt_peak = torch.cuda.max_memory_allocated(dev)
    Tg = gt.num_frames(S)
    if tuple(g.shape) != (B, Tg, gcfg.num_channels) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"gammatone features: shape {tuple(g.shape)} or non-finite")
    gt_ms = cuda_ms(lambda: gt(samples, lengths), 3)
    C_, Lk = gt.kernels.shape
    Lw = gcfg.integration_length
    gt_flop = 2.0 * B * C_ * S * Lk + 2.0 * B * C_ * Tg * Lw + B * C_ * S
    gt_bound = bound(gt_flop, 4.0 * (B * S + B * Tg * C_))
    g2, _ = gt(x2, n2)
    g2c, _ = GammatoneFrontend(gcfg, device="cpu")(x2.cpu(), n2.cpu())
    gt_err = check_close("gammatone cuda vs cpu", g2.cpu(), g2c, GT_RTOL, GT_ATOL)
    say(f"gammatone B={B} x {AUDIO_S:g} s ({Tg} frames x {C_} channels, {Lk}-tap filters, "
        f"{Lw}-sample integration): {gt_host_ms:.1f} ms host clock, {gt_ms:.3f} ms (CUDA "
        f"events, 3 calls), bound {gt_bound[0]:.3f} ms ({gt_bound[1]}, fp32 pipes); peak "
        f"device memory {gt_peak / 2**30:.2f} GiB; launches {gt_counts}; card vs cpu on "
        f"B=2 x 3 s max abs err {gt_err:.3e} (tolerance {GT_ATOL} + {GT_RTOL} x value)")
    del g, g2

    # VTLN: the seven default factors on VTLN_BATCH utterances, aligned with
    # the align-em path's EM model against its graphs
    x8, n8 = samples[:VTLN_BATCH], lengths[:VTLN_BATCH]
    fkw = dict(splice_context=4, lda=s.lda)
    reset_counts()
    t0 = time.time()
    best, costs = estimate_warping_factor(
        x8, n8, graphs[:VTLN_BATCH], BatchAligner(GmmFeatureScorer(em_model, device=dev)),
        FrontendConfig(), frontend_kwargs=fkw, device=dev)
    vtln_s = time.time() - t0
    vtln_counts = read_counts("vtln estimate", gmm_scores, mfcc_frames)
    t0 = time.time()
    best_c, costs_c = estimate_warping_factor(
        x8.cpu(), n8.cpu(), graphs[:VTLN_BATCH],
        BatchAligner(GmmFeatureScorer(em_model, device="cpu")), FrontendConfig(),
        frontend_kwargs=fkw, device="cpu")
    vtln_cpu_s = time.time() - t0
    rel = max(abs(costs[a] - costs_c[a]) / abs(costs_c[a]) for a in costs_c)
    if best != best_c or list(costs) != list(costs_c) or rel > ALIGN_RTOL:
        raise AssertionError(f"vtln card vs cpu: {best} {costs} vs {best_c} {costs_c}")
    say(f"vtln estimate over {len(costs)} factors on {VTLN_BATCH} x {AUDIO_S:g} s: card "
        f"{vtln_s:.1f} s, cpu {vtln_cpu_s:.1f} s; best alpha {best} on both; costs "
        + ", ".join(f"{a:g}: {c:.1f}" for a, c in costs.items())
        + f"; card vs cpu within {rel:.2e} relative (tolerance {ALIGN_RTOL}); launches "
        f"{vtln_counts}")
    return err, counts


def grammar_network(s, rng):
    """A command grammar over words of the main path's lexicon as a WFST
    network: ``FsaGrammarLm.from_sequences`` over WFST_SENTENCES sentences,
    made deterministic and minimal, each word arc expanded into the word's
    HMM state chain (its emission classes, the grammar weight and forward
    cost on the first arc, the word label on the last), every node after
    the first word final, compiled by ``compile_wfst`` with the main
    path's LM scoring the words."""
    from rasr_tpu_torch.align.graph import build_linear_graph
    from rasr_tpu_torch.fsa.algorithms import determinize, minimize, remove_epsilon
    from rasr_tpu_torch.fsa.automaton import Automaton
    from rasr_tpu_torch.models.hmm import HmmTopology, TransitionModel
    from rasr_tpu_torch.models.lm.grammar import FsaGrammarLm
    from rasr_tpu_torch.search.wfst import compile_wfst

    times = {}
    t0 = time.time()
    lemmas = [lemma for lemma in s.lexicon.lemmata if not lemma.special]
    vocab = [lemmas[i] for i in rng.choice(len(lemmas), size=WFST_WORDS, replace=False)]
    sentences = [[vocab[i].primary_orth for i in rng.integers(0, WFST_WORDS,
                                                               size=int(rng.integers(2, 6)))]
                 for _ in range(WFST_SENTENCES)]
    grammar = FsaGrammarLm.from_sequences(sentences)
    det = minimize(determinize(remove_epsilon(grammar.fsa)))
    times["grammar"] = time.time() - t0
    t0 = time.time()
    topo, tdp = HmmTopology(states_per_phone=3, silence_states=1), TransitionModel().speech
    index = {lemma.primary_orth: i for i, lemma in enumerate(vocab)}
    orth_of = {v: k for k, v in grammar.vocab.items()}
    chains = {}
    net = Automaton()
    for _ in range(det.num_states):
        net.add_state()
    net.initial = det.initial
    # a command may stop after any word (at WFST_STOP_COST where the
    # grammar's sentence goes on), so that a path can complete at the last
    # frame whatever the commands' lengths
    for st in range(det.num_states):
        if st != det.initial:
            net.set_final(st, det.finals.get(st, WFST_STOP_COST))
    for st in range(det.num_states):
        for arc in det.arcs[st]:
            w = index[orth_of[arc.ilabel]]
            if w not in chains:
                chains[w] = build_linear_graph(vocab[w].primary_orth, s.lexicon, s.tying, topo,
                                               optional_silence=False).emission_ids
            cur = st
            for k, cls in enumerate(chains[w]):
                last = k == len(chains[w]) - 1
                nxt = arc.target if last else net.add_state()
                net.add_arc(cur, nxt, int(cls) + 1, w + 1 if last else 0,
                            (arc.weight if k == 0 else 0.0) + tdp.forward)
                cur = nxt
    times["expand"] = time.time() - t0
    t0 = time.time()
    tree = compile_wfst(net, s.tying.num_classes, vocab, tdp.loop,
                        {i: s.lm.vocab[lemma.primary_orth] for i, lemma in enumerate(vocab)})
    times["compile_wfst"] = time.time() - t0
    sizes = dict(grammar_states=grammar.fsa.num_states, minimal_states=det.num_states,
                 minimal_arcs=sum(len(a) for a in det.arcs), network_states=net.num_states)
    return tree, times, sizes


def wfst_phase(s, dev, samples, lengths, rng, say, reset_counts, read_counts):
    """Grammar-constrained recognition over a composed network: the
    command grammar (``grammar_network``), its re-entry lookahead
    (``lookahead._wordset_general``), the bench batch through MFCC -> GMM
    -> the decoder under the production beam; the card against the CPU,
    and one card lattice bridged to an FSA whose best path is the
    decoder's. Returns the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from rasr_tpu_torch.fsa.algorithms import best
    from rasr_tpu_torch.lattice.lattice import decoder_lattice, lattice_to_fsa
    from rasr_tpu_torch.models.lm.ngram import compile_ngram
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores
    from rasr_tpu_torch.ops.kernels.mfcc import mfcc_frames
    from rasr_tpu_torch.search.decoder import TreeDecoder
    from rasr_tpu_torch.search.lookahead import build_bigram_lookahead
    from rasr_tpu_torch.synthetic import auto_branch_width

    tree, times, sizes = grammar_network(s, rng)
    t0 = time.time()
    la = build_bigram_lookahead(tree, s.lm, num_classes=WFST_LA_CLASSES)
    times["lookahead"] = time.time() - t0
    if la is None or not la.reentry:
        raise AssertionError("wfst: no re-entry lookahead for the grammar network")
    junctions = np.unique(tree.we_next[tree.we_next > 0])
    beam = dataclasses.replace(s.beam, branch_width=auto_branch_width(tree, s.beam))
    dec = TreeDecoder(tree, compile_ngram(s.lm), beam, bigram_la=la, device=dev)
    say(f"wfst network: {sizes}; tree {tree.stats()}, {junctions.size} junction states; "
        f"lookahead {la.corr.shape[1] - 1} nodes x {la.corr.shape[0]} classes, reentry "
        f"{la.reentry}; host " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
        + f"; branch width {beam.branch_width}")

    def run(x, n):
        t_a = time.time()
        f, nf = s.frontend(x, n)
        e = s.scorer(f)
        torch.cuda.synchronize()
        t_b = time.time()
        handle = dec.decode_scores_device(e, nf)
        res = dec.results_from_device(handle)
        return e, nf, handle, res, np.array([t_b - t_a, time.time() - t_b])

    run(samples[:, :16000], torch.full_like(lengths, 16000))  # warm-up on 1 s
    reset_counts()
    e, nf, _, results, dt = run(samples, lengths)
    counts = read_counts("wfst path", gmm_scores, mfcc_frames)
    B = samples.shape[0]
    if len(results) != B or not all(np.isfinite(r.score) and r.words for r in results):
        raise AssertionError("wfst decode produced an empty or non-finite result")
    say(f"wfst path B={B} x {AUDIO_S:g} s: frontend + scorer {dt[0] * 1e3:.1f} ms, decode "
        f"{dt[1] * 1e3:.1f} ms; {B * AUDIO_S / dt.sum():.1f} audio-s/s; launches {counts}; "
        f"sample {results[0].orth[:60]!r} score {results[0].score:.3f}")
    del e, results

    # card == CPU on B=2 x 3 s, and a card lattice as an FSA
    small = int(3.0 * 16000)
    f2, nf2 = s.frontend(samples[:2, :small], torch.full((2,), small, device=dev))
    e2 = s.scorer(f2)
    on_cpu = TreeDecoder(tree, compile_ngram(s.lm), beam, bigram_la=la, device="cpu")
    handle = dec.decode_scores_device(e2, nf2)
    a = dec.results_from_device(handle)
    b = on_cpu.decode_scores(e2.cpu(), nf2.cpu())
    for x, y in zip(a, b):
        if x.words != y.words or abs(x.score - y.score) > DECODE_RTOL * max(1.0, abs(y.score)):
            raise AssertionError(f"cuda vs cpu decode (wfst): {x.words} {x.score} vs "
                                 f"{y.words} {y.score}")
    if not all(r.word_ends and r.word_ends[-1] == int(n) - 1 for r, n in zip(a, nf2.tolist())):
        raise AssertionError(f"wfst: a best path does not complete at the last frame: "
                             f"{[r.word_ends[-3:] for r in a]}")
    lat = decoder_lattice(handle, tree.lemmas, 0)
    fsa = lattice_to_fsa(lat)
    cost, arcs = best(fsa)
    labels = [fsa.input_symbols[arc.ilabel] for arc in arcs if arc.ilabel]
    if labels != a[0].words or abs(cost - a[0].score) > 1e-4 * abs(a[0].score):
        raise AssertionError(f"wfst lattice as an FSA: best {labels} {cost} vs the decoder's "
                             f"{a[0].words} {a[0].score}")
    say(f"wfst card vs cpu on B=2 x 3 s: decode equal {[r.orth[:40] for r in a]}; lattice 0 "
        f"({lat.num_nodes} nodes, {len(lat.arcs)} arcs) as an FSA: best path == the "
        f"decoder's ({len(labels)} words, cost {cost:.3f} vs {a[0].score:.3f})")
    return counts


# -------------------------------------------------------------- the tools phase
def lexicon_xml(lex) -> str:
    """The lexicon as the Bliss XML that ``Lexicon.load`` reads (phonemes in
    id order, lemmas in id order, so the ids come back unchanged)."""
    from xml.sax.saxutils import escape

    out = ["<lexicon><phoneme-inventory>"]
    for ph in lex.phonemes:
        var = "<variation>none</variation>" if ph.context_independent else ""
        out.append(f"<phoneme><symbol>{escape(ph.symbol)}</symbol>{var}</phoneme>")
    out.append("</phoneme-inventory>")
    for lemma in lex.lemmata:
        attr = f' special="{lemma.special}"' if lemma.special else ""
        orths = "".join(f"<orth>{escape(o)}</orth>" for o in lemma.orth)
        phons = "".join(
            f'<phon score="{p.score!r}">'
            + " ".join(lex.phonemes.by_id(i).symbol for i in p.phonemes) + "</phon>"
            for p in lemma.pronunciations)
        extra = "<synt/><eval/>" if lemma.special == "silence" else ""
        out.append(f"<lemma{attr}>{orths}{phons}{extra}</lemma>")
    out.append("</lexicon>")
    return "".join(out)


def run_tool(module, args, workdir, label):
    """``python -m rasr_tpu_torch.tools.<module> args`` in ``workdir`` with a
    JSONL log -> (stdout, log records, wall seconds, kernel launches)."""
    import subprocess

    log = os.path.join(workdir, f"{label}.jsonl")
    cmd = [sys.executable, "-m", f"rasr_tpu_torch.tools.{module}", *args, f"--*.log-file={log}"]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=workdir, env=dict(os.environ, PYTHONPATH=HERE),
                          capture_output=True, text=True, timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{module} ({label}) exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
    with open(log) as fh:
        records = [json.loads(line) for line in fh]
    (counts,) = [r for r in records if r.get("msg") == "kernel launches"]
    counts = {k: counts[k] for k in ("gmm_scores", "mfcc_frames", "wordend_block", "row_gather")}
    return proc.stdout, records, wall, counts


def tools_phase(s, dev, corpus_path, c4, samples, lengths, say, reset_counts, read_counts):
    """The port's tool chain as separate processes at the main path's
    width, the in-process recognizer beside it, the packed per-slot LM
    against the bucketed tables, and a class LM. Returns the kernel
    launches of the phase (the tools' own and the in-process ones). Its
    random draws come from a generator of its own, so the later phases
    see the draws they saw before it."""
    import dataclasses

    import numpy as np
    import torch

    from rasr_tpu_torch.corpus.bliss import CorpusDescription
    from rasr_tpu_torch.corpus.lexicon import Lexicon
    from rasr_tpu_torch.device import cuda_ms
    from rasr_tpu_torch.lattice.evaluator import CorpusEvaluator
    from rasr_tpu_torch.models.cart import CartTree
    from rasr_tpu_torch.models.gmm import MixtureSet
    from rasr_tpu_torch.models.hmm import HmmTopology, TransitionModel
    from rasr_tpu_torch.models.lm.arpa import NgramLm
    from rasr_tpu_torch.models.lm.classlm import ClassLm
    from rasr_tpu_torch.models.lm import ngram
    from rasr_tpu_torch.models.lm.ngram import compile_ngram, lookup_prepared, prepare_lookup
    from rasr_tpu_torch.models.lm.packed import PackedNgramLm, compile_packed
    from rasr_tpu_torch.models.scorer import GmmFeatureScorer
    from rasr_tpu_torch.models.tying import CartStateTying
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores
    from rasr_tpu_torch.ops.kernels.mfcc import mfcc_frames
    from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
    from rasr_tpu_torch.pipeline.visitor import CorpusVisitor
    from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu_torch.search.tree import build_prefix_tree
    from rasr_tpu_torch.synthetic import PRODUCTION_BEAM, auto_branch_width
    from rasr_tpu_torch.tools.feature_extraction import (
        FeatureExtractionTool, frontend_from_config,
    )
    from rasr_tpu_torch.utils.archive import FileArchive
    from rasr_tpu_torch.utils.config import Configuration

    t_phase = time.time()
    rng = np.random.default_rng(TOOLS_SEED)
    total = {"gmm_scores": 0, "mfcc_frames": 0, "wordend_block": 0, "row_gather": 0}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    work = tempfile.TemporaryDirectory()
    wd = work.name
    paths = {name: os.path.join(wd, name) for name in (
        "lexicon.xml", "lm.arpa", "lda.npy", "mono.mix", "cart.json", "tri.mix", "net.img",
        "segments.txt", "4gram.arpa")}
    with open(paths["lexicon.xml"], "w") as fh:
        fh.write(lexicon_xml(s.lexicon))
    s.lm.write_arpa(paths["lm.arpa"])
    np.save(paths["lda.npy"], s.lda)
    corpus = CorpusDescription.load(corpus_path)
    segments = list(corpus.segments())
    audio_s = {seg.full_name: len(CorpusVisitor(corpus, 1)._read(seg)) / 16000
               for seg in segments}
    audio_total = sum(audio_s.values())
    frontend_args = ["--*.frontend.splice=4", f"--*.frontend.lda-file={paths['lda.npy']}"]
    # the tools' frontend is the main path's
    config = Configuration()
    config.parse_args([*frontend_args, f"--*.device={dev}"])
    fe = frontend_from_config(FeatureExtractionTool(config))
    if (fe.cfg, fe.splice_context, fe.delta_order) != (
            s.frontend.cfg, s.frontend.splice_context, s.frontend.delta_order) or not \
            torch.equal(fe.lda.cpu(), s.frontend.lda.cpu()):
        raise AssertionError("the tools' frontend is not the main path's")
    say(f"tools phase: the main path's setup as files ({len(s.lexicon.lemmata)} lemmas, "
        f"{len(s.lm.ngrams)} n-grams, LDA {s.lda.shape}), {len(segments)} segments of "
        f"{audio_total:.1f} audio-s; frontend_from_config == the main path's frontend")

    def tool(module, args, label):
        out, records, wall, counts = run_tool(module, args, wd, label)
        add(counts)
        say(f"tool {label}: {wall:.1f} s, launches {counts}")
        return out, records

    # 1. lm-util
    out, _ = tool("lm_util", ["--lm-util.action=statistics",
                              f"--lm-util.lm-file={paths['lm.arpa']}"], "lm-util statistics")
    stats = json.loads(out)
    if stats["order"] != s.lm.order or stats["vocab"] != len(s.lm.vocab):
        raise AssertionError(f"lm-util statistics: {stats}")
    out, _ = tool("lm_util", ["--lm-util.action=compile-check",
                              f"--lm-util.lm-file={paths['lm.arpa']}"], "lm-util compile-check")
    if json.loads(out)["states"] != s.decoder.lm.num_states:
        raise AssertionError(f"lm-util compile-check: {out}")

    # 2-4. monophones, CART, triphones
    amt = ["--acoustic-model-trainer.corpus-file=" + corpus_path,
           "--acoustic-model-trainer.lexicon-file=" + paths["lexicon.xml"],
           "--acoustic-model-trainer.states-per-phone=3",
           f"--acoustic-model-trainer.batch-size={len(segments)}", *frontend_args]
    train = [f"--acoustic-model-trainer.iterations={TOOLS_ITERATIONS}",
             f"--acoustic-model-trainer.splits={TOOLS_SPLITS}"]
    tool("acoustic_model_trainer", [*amt, *train, "--acoustic-model-trainer.action=train",
                                    f"--acoustic-model-trainer.new-mixture-file={paths['mono.mix']}"],
         "acoustic-model-trainer train (monophones)")
    mono = MixtureSet.load(paths["mono.mix"])
    _, records = tool("acoustic_model_trainer", [
        *amt, "--acoustic-model-trainer.action=estimate-cart",
        f"--acoustic-model-trainer.mixture-file={paths['mono.mix']}",
        f"--acoustic-model-trainer.cart-output-file={paths['cart.json']}",
        f"--acoustic-model-trainer.cart-max-leaves={TOOLS_MAX_LEAVES}"],
        "acoustic-model-trainer estimate-cart")
    (cart_rec,) = [r for r in records if r.get("msg") == "cart estimated"]
    tool("acoustic_model_trainer", [*amt, *train, "--acoustic-model-trainer.action=train",
                                    f"--acoustic-model-trainer.cart-file={paths['cart.json']}",
                                    f"--acoustic-model-trainer.new-mixture-file={paths['tri.mix']}"],
         "acoustic-model-trainer train (CART triphones)")
    tri = MixtureSet.load(paths["tri.mix"])
    say(f"monophones {mono.means.shape}; CART: {cart_rec['contexts']} contexts seen -> "
        f"{cart_rec['leaves']} leaves (of {TOOLS_MAX_LEAVES} asked) in "
        f"{cart_rec['train_seconds']:.1f} host s; triphone mixtures {tri.means.shape}")
    if tri.max_densities != 2 ** TOOLS_SPLITS or tri.num_mixtures != cart_rec["leaves"]:
        raise AssertionError(f"triphone mixtures {tri.means.shape}")

    # the in-process system from the same files, and its production beam
    t0 = time.time()
    lexicon = Lexicon.load(paths["lexicon.xml"])
    tying = CartStateTying(CartTree.load(paths["cart.json"]), lexicon)
    lm = NgramLm.read_arpa(paths["lm.arpa"])
    tree = build_prefix_tree(lexicon, tying, HmmTopology(states_per_phone=3), TransitionModel(),
                             lm_vocab=lm.vocab,
                             lm_unigrams={w: lm.score((), w) for w in lm.vocab.values()},
                             skip_scope="phone")
    beam = dataclasses.replace(PRODUCTION_BEAM,
                               branch_width=auto_branch_width(tree, PRODUCTION_BEAM))
    build_s = time.time() - t0

    # 5. the recognizer, twice: the network image built and saved, then loaded
    sr = ["--speech-recognizer.corpus-file=" + corpus_path,
          "--speech-recognizer.lexicon-file=" + paths["lexicon.xml"],
          "--speech-recognizer.lm-file=" + paths["lm.arpa"],
          "--speech-recognizer.mixture-file=" + paths["tri.mix"],
          "--speech-recognizer.cart-file=" + paths["cart.json"],
          "--speech-recognizer.skip-scope=phone",
          "--speech-recognizer.network-cache=" + paths["net.img"],
          "--speech-recognizer.search.max-hyps=1024",
          "--speech-recognizer.search.word-end-limit=64",
          "--speech-recognizer.search.root-hyps=16",
          "--speech-recognizer.search.branch-hyps=146",
          "--speech-recognizer.search.root-arc-limit=160",
          "--speech-recognizer.search.root-select=512",
          "--speech-recognizer.search.deferred-emission=true",
          "--speech-recognizer.search.lm-scale=10.0",
          f"--speech-recognizer.search.branch-width={beam.branch_width}", *frontend_args]
    runs = {}
    for run, source in ((1, "network image saved"), (2, "network image loaded")):
        lat, ctm = os.path.join(wd, f"lat{run}"), os.path.join(wd, f"ctm{run}")
        out, records = tool("speech_recognizer", [
            *sr, f"--speech-recognizer.batch-size={len(segments)}",
            f"--speech-recognizer.lattice-archive={lat}", f"--speech-recognizer.ctm-file={ctm}"],
            f"speech-recognizer run {run}")
        if not any(r.get("msg") == source for r in records):
            raise AssertionError(f"speech-recognizer run {run}: no {source!r} record")
        (cfg_rec,) = [r for r in records if r.get("msg") == "search configuration"]
        got = BeamConfig(**{f.name: cfg_rec[f.name] for f in dataclasses.fields(BeamConfig)})
        if got != beam:
            raise AssertionError(f"the tool's beam {got} is not the production beam {beam}")
        (ready,) = [r for r in records if r.get("msg") == "network ready"]
        words = {r["segment"]: r["recognized"] for r in records if r.get("msg") == "recognized"}
        wer = [line for line in out.splitlines() if line.startswith("WER:")]
        with FileArchive(lat, "r") as ar:
            lattices = {k: ar.read(k) for k in ar.keys()}
        with open(ctm) as fh:
            runs[run] = dict(words=words, wer=wer, lattices=lattices, ctm=fh.read())
        rec_t = [r["t"] for r in records if r.get("msg") == "recognized"]
        runs[run]["decode_s"] = max(rec_t) - ready["t"]
        say(f"speech-recognizer run {run} ({source}): network setup {ready['seconds']:.2f} s; "
            f"{len(words)} segments recognized {ready['t']:.1f}-{max(rec_t):.1f} s into the "
            f"process ({audio_total / runs[run]['decode_s']:.1f} audio-s/s); {wer[0]}")
    if any(runs[1][k] != runs[2][k] for k in ("words", "wer", "lattices", "ctm")):
        raise AssertionError("the image run differs from the build run")

    # 6. the in-process recognizer from the same files == the tool
    reset_counts()
    t0 = time.time()
    rec = OfflineRecognizer(
        fe, GmmFeatureScorer(MixtureSet.load(paths["tri.mix"]), device=dev),
        TreeDecoder(tree, compile_ngram(lm), beam, device=dev))
    results = rec.run(CorpusVisitor(corpus, batch_size=len(segments)))
    wall = time.time() - t0
    add(read_counts("tools phase (in-process recognizer)", gmm_scores, mfcc_frames))
    mine = {r.segment_name: r.orth for r in results}
    if mine != runs[1]["words"]:
        bad = [k for k in mine if mine[k] != runs[1]["words"].get(k)]
        raise AssertionError(f"in-process recognizer vs the tool: {len(bad)} segments differ, "
                             f"e.g. {bad[:1]}: {mine[bad[0]]!r} vs {runs[1]['words'][bad[0]]!r}")
    say(f"in-process OfflineRecognizer == the tool on {len(mine)} segments (network build "
        f"{build_s:.1f} s, recognition {wall:.2f} s: {audio_total / wall:.1f} audio-s/s)")

    # the same tool on the CPU, on the 4 shortest segments
    shortest = sorted(audio_s, key=audio_s.get)[:TOOLS_CPU_SEGMENTS]
    with open(paths["segments.txt"], "w") as fh:
        fh.write("\n".join(shortest) + "\n")
    out, records = tool("speech_recognizer", [
        *sr, f"--speech-recognizer.batch-size={TOOLS_CPU_SEGMENTS}",
        f"--speech-recognizer.segment-list-file={paths['segments.txt']}", "--*.device=cpu"],
        f"speech-recognizer on the cpu ({TOOLS_CPU_SEGMENTS} segments)")
    cpu_words = {r["segment"]: r["recognized"] for r in records if r.get("msg") == "recognized"}
    ev = CorpusEvaluator()
    refs = {seg.full_name: seg.orth for seg in segments}
    for name in shortest:
        ev.add(name, refs[name], runs[1]["words"][name])
    rep = ev.report()
    card_wer = f"WER: {rep['wer']:.4f} ({rep['errors']} errors / {rep['ref_len']} words)"
    cpu_wer = [line for line in out.splitlines() if line.startswith("WER:")]
    if cpu_words != {k: runs[1]["words"][k] for k in shortest} or cpu_wer != [card_wer]:
        raise AssertionError(f"the tool on the cpu: {cpu_words} {cpu_wer} vs the card's "
                             f"{card_wer}")
    say(f"the tool on the cpu == on the card on {len(shortest)} segments "
        f"({sum(audio_s[k] for k in shortest):.1f} audio-s): {card_wer}")

    # 7. the packed LM: the native parse, per-slot tables against the bucketed ones
    def packed_vs_bucketed(label, arpa, tree_, beam_, e, n):
        t0 = time.time()
        plm = PackedNgramLm.from_arpa(arpa)
        parse_s = time.time() - t0
        if not os.path.exists(arpa + ".lmbin"):
            raise AssertionError(f"{label}: the native parser wrote no .lmbin")
        t0 = time.time()
        packed = compile_packed(plm)
        packed_s = time.time() - t0
        t0 = time.time()
        bucketed = compile_ngram(NgramLm.read_arpa(arpa))
        bucketed_s = time.time() - t0
        if packed.bucket_bits != 0 or packed.num_states != bucketed.num_states:
            raise AssertionError(f"{label}: packed tables {packed.bucket_bits} bits, "
                                 f"{packed.num_states} states")
        decs = {"bucketed": TreeDecoder(tree_, bucketed, beam_, device=dev),
                "packed": TreeDecoder(tree_, packed, beam_, device=dev)}
        out_, rate, look = {}, {}, {}
        B_ = e.shape[0]
        q = torch.from_numpy(rng.integers(0, packed.num_states, size=B_ * 64)).to(dev)
        w = torch.from_numpy(rng.integers(0, len(plm.vocab), size=B_ * 64)).to(dev)
        for name, dec in decs.items():
            torch.cuda.synchronize()
            t0 = time.time()
            out_[name] = dec.decode_scores(e, n)
            torch.cuda.synchronize()
            rate[name] = B_ * float(n.max()) / 100 / (time.time() - t0)
            look[name] = cuda_ms(lambda d=dec: lookup_prepared(d.lm, d.lm_prep, q, w), 20)
        for a, b in zip(out_["packed"], out_["bucketed"]):
            if a.words != b.words or a.score != b.score:
                raise AssertionError(f"{label}: packed {a.words} {a.score} vs bucketed "
                                     f"{b.words} {b.score}")
        dp = decs["packed"]
        prep = dp.lm_prep
        # the same per-slot tables on the route a table above REP_WINDOW_BYTES
        # takes (one gather per probe): the same answers, and its lookup time
        limit, ngram.REP_WINDOW_BYTES = ngram.REP_WINDOW_BYTES, 0
        try:
            per_probe = prepare_lookup(dp.lm)
        finally:
            ngram.REP_WINDOW_BYTES = limit
        if per_probe.probes != max(packed.max_probe, 1) or any(
                not torch.equal(a, b) for a, b in zip(lookup_prepared(dp.lm, per_probe, q, w),
                                                      lookup_prepared(dp.lm, prep, q, w))):
            raise AssertionError(f"{label}: the per-probe route differs from the windows")
        look["per-probe"] = cuda_ms(lambda: lookup_prepared(dp.lm, per_probe, q, w), 20)
        prep_mb = sum(t.numel() * t.element_size() for t in prep[:8]) / 2**20
        say(f"{label}: native parse {parse_s:.2f} s, compile_packed {packed_s:.2f} s (per-slot: "
            f"H={packed.table_size}, max_probe={packed.max_probe}, "
            f"{'replicated windows' if not prep.probes else f'{prep.probes} probe gathers'}, "
            f"lookup tables {prep_mb:.1f} MiB), compile_ngram {bucketed_s:.2f} s (bucketed: "
            f"H={bucketed.table_size}); B={B_} decodes bit-equal; audio-s/s packed "
            f"{rate['packed']:.1f}, bucketed {rate['bucketed']:.1f}; one lookup of {q.numel()} "
            f"queries (CUDA events) packed {look['packed'] * 1e3:.1f} us, bucketed "
            f"{look['bucketed'] * 1e3:.1f} us; per-slot forced to one gather per probe "
            f"{look['per-probe'] * 1e3:.1f} us (equal answers)")

    # the emissions of the packed and class-LM decodes: the phase's own
    # launches, counted from here to the class LM's scorer call
    reset_counts()
    feats, n = s.frontend(samples, lengths)
    packed_vs_bucketed("packed LM (main path)", paths["lm.arpa"], s.tree, s.beam,
                       s.scorer(feats), n)
    c4.lm.write_arpa(paths["4gram.arpa"])
    B4 = PACKED_4GRAM_BATCH
    f4, n4 = c4.frontend(samples[:B4], lengths[:B4])
    # the packed layout numbers LM states per order, so the trigram lookahead
    # (keyed by compile_ngram's state ids) cannot ride it: both decoders are
    # built without it
    packed_vs_bucketed("packed LM (4-gram path, no lookahead)", paths["4gram.arpa"], c4.tree,
                       c4.beam, c4.scorer(f4), n4)

    # 8. a class LM over the main path's vocabulary: card == cpu
    words = [w for w in s.lm.vocab if w not in ("<s>", "</s>", "<unk>")]
    w2c = {w: f"C{int(c)}" for w, c in zip(words, rng.integers(0, CLASSLM_CLASSES, len(words)))}
    sentences = [[w2c[w] for w in rng.choice(words, size=int(rng.integers(3, 12)))]
                 for _ in range(CLASSLM_SENTENCES)]
    # every class (and <unk>) in the class LM's vocabulary
    sentences.append([f"C{c}" for c in range(CLASSLM_CLASSES)] + ["<unk>"])
    t0 = time.time()
    clm = ClassLm(NgramLm.train_from_text(sentences, order=2), s.lm.vocab, w2c)
    ctables = clm.compile_to_device()
    compile_s = time.time() - t0
    small = int(3.0 * 16000)
    f3, n3 = s.frontend(samples[:4, :small], torch.full((4,), small, device=dev))
    e3 = s.scorer(f3)
    add(read_counts("tools phase (packed and class-LM emissions)", gmm_scores, mfcc_frames))
    card = TreeDecoder(s.tree, ctables, s.beam, device=dev).decode_scores(e3, n3)
    cpu = TreeDecoder(s.tree, ctables, s.beam, device="cpu").decode_scores(e3.cpu(), n3.cpu())
    for a, b in zip(card, cpu):
        if a.words != b.words or abs(a.score - b.score) > DECODE_RTOL * max(1.0, abs(b.score)):
            raise AssertionError(f"class LM cuda vs cpu: {a.words} {a.score} vs {b.words} "
                                 f"{b.score}")
    say(f"class LM ({CLASSLM_CLASSES} classes, {len(clm.class_lm.ngrams)} class n-grams -> "
        f"{ctables.table_size} slots, {compile_s:.1f} s): cuda == cpu decode on B=4 x 3 s: "
        f"{[r.orth[:30] for r in card]}")
    work.cleanup()
    say(f"tools phase {time.time() - t_phase:.1f} s, launches {total}")
    return total


# ----------------------------------------------------------- the parallel phase
def parallel_inputs(dev, num_classes: int):
    """The phase's draws (every rank makes the same): the partitioned
    beams' batch, the DP EM batch with random labels, the long recording
    and its alignment graph's emission classes."""
    import numpy as np
    import torch

    from rasr_tpu_torch.ops.frontend import FrontendConfig, num_frames

    rng = np.random.default_rng(PARALLEL_SEED)
    S = int(AUDIO_S * 16000)

    def noise(B, n):
        return torch.from_numpy((rng.normal(size=(B, n)) * 0.1).astype(np.float32)).to(dev)

    batch = noise(PARALLEL_BATCH, S)
    em_batch = noise(BATCH, S)
    labels = rng.integers(0, num_classes, size=BATCH * num_frames(S, FrontendConfig()))
    recording = noise(1, int(SP_SECONDS * 16000))
    graph_ids = rng.integers(0, num_classes, size=SP_STATES)
    return batch, em_batch, labels, recording, graph_ids


def exact_beam():
    from rasr_tpu_torch.search.decoder import BeamConfig

    return BeamConfig(max_hyps=1024, beam=1e9, word_end_limit=64, root_hyps=1024,
                      branch_hyps=1024, lm_scale=10.0)


def wer_counts(corpus, results) -> list:
    """(errors, reference words) of recognizer results against the corpus."""
    from rasr_tpu_torch.lattice.evaluator import align_tokens

    orth = {seg.full_name: seg.orth for seg in corpus.segments()}
    err = ref = 0
    for r in results:
        st, _ = align_tokens(orth[r.segment_name].split(), r.words)
        err, ref = err + st.errors, ref + st.reference_length
    return [float(err), float(ref)]


def parallel_phase(s, dev, corpus, corpus_path, single, audio_total, say, reset_counts,
                   read_counts):
    """Data parallelism, TP scoring, the partitioned beam, sequence
    parallelism, the dry run and the two examples (``rasr_tpu_torch.parallel``):
    the world of one rank over NCCL here, then ``PARALLEL_WORLD`` gloo ranks
    (this script with ``--parallel-rank``) on the same card. ``single`` is
    the recognizer's best-only run over ``corpus`` (``audio_total`` s of
    audio). Returns the phase's
    GMM and MFCC launches, its own and its ranks'."""
    import numpy as np
    import torch

    from rasr_tpu_torch.examples import beam_sweep, streaming_demo
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores
    from rasr_tpu_torch.ops.kernels.mfcc import mfcc_frames
    from rasr_tpu_torch.parallel import mesh as pm
    from rasr_tpu_torch.parallel.sharded import psum_counters
    from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
    from rasr_tpu_torch.pipeline.visitor import CorpusVisitor
    from rasr_tpu_torch.search.decoder import TreeDecoder

    t_phase = time.time()
    work = tempfile.mkdtemp(prefix="parallel-")
    single_words = {name: r.words for name, r in single.items()}
    counts = wer_counts(corpus, single.values())
    reset_counts()

    # ---- world 1 over NCCL: the DP recognizer through the mesh code
    pm.init_distributed("nccl", "file://" + os.path.join(work, "store1"), 0, 1)
    try:
        mesh = pm.make_mesh(1, 1, device=dev)
        rec = OfflineRecognizer(s.frontend, s.scorer, s.decoder, mesh=mesh)
        torch.cuda.synchronize()
        t_a = time.time()
        got = rec.run(CorpusVisitor(corpus, batch_size=RECOGNIZER_SEGMENTS))
        wall1 = time.time() - t_a
        merged = psum_counters(mesh, np.array([wer_counts(corpus, got)])).tolist()
    finally:
        torch.distributed.destroy_process_group()
    if {r.segment_name: r.words for r in got} != single_words or merged != counts:
        raise AssertionError(f"world-1 DP recognizer != the recognizer ({merged} vs {counts})")
    say(f"parallel world 1 (nccl, {dev}): DP recognizer == recognizer on {len(got)} segments, "
        f"{wall1:.2f} s; WER counters (errors, words) {merged} == the single run's")

    # ---- the single-rank decodes the partitioned beams are held to
    batch, *_ = parallel_inputs(dev, s.tying.num_classes)
    feats, n = s.frontend(batch, torch.full((PARALLEL_BATCH,), batch.shape[1], device=dev))
    emis = s.scorer(feats)
    torch.save({"emis": emis.cpu(), "n": n.cpu()}, os.path.join(work, "emis.pt"))
    ref = {}
    for label, cfg in (("exact", exact_beam()), ("production", s.beam)):
        dec = TreeDecoder(s.tree, s.decoder.lm, cfg, tables=s.decoder.tables, device=dev)
        torch.cuda.synchronize()
        t_a = time.time()
        res = dec.decode_scores(emis, n)
        ref[label] = dict(words=[r.words for r in res], scores=[r.score for r in res],
                          wall=time.time() - t_a)
    audio16 = PARALLEL_BATCH * AUDIO_S
    with open(os.path.join(work, "inputs.json"), "w") as fh:
        json.dump(dict(corpus=corpus_path, single=single_words, counts=counts,
                       decodes=ref), fh)
    local = read_counts("parallel phase (world 1, single decodes)", gmm_scores, mfcc_frames)

    # ---- PARALLEL_WORLD ranks over gloo on this card
    t_a = time.time()
    outs = pm.spawn_ranks([sys.executable, os.path.abspath(__file__), "--parallel-rank", work],
                          PARALLEL_WORLD, "file://" + os.path.join(work, "store"), 900)
    ranks = [json.loads(next(line for line in out.splitlines()
                             if line.startswith("PARALLEL-RANK "))[len("PARALLEL-RANK "):])
             for out in outs]
    wall_ranks = time.time() - t_a
    r0 = ranks[0]
    say(f"parallel world {PARALLEL_WORLD} (gloo, both ranks on {dev}) in {wall_ranks:.1f} s "
        f"(process starts and setup {r0['startup_s']:.1f} s): DP recognizer (2 x 1) == "
        f"recognizer, {audio_total:.1f} audio-s in {r0['recognizer_s']:.2f} s: "
        f"{audio_total / r0['recognizer_s']:.1f} audio-s/s (world 1 {audio_total / wall1:.1f}); "
        f"merged WER counters {r0['counters']} == the single run's")
    say(f"TP scorer (1 x 2) == GmmFeatureScorer: min max abs err {r0['tp_err']:.3e}, LSE "
        f"{r0['tp_lse_err']:.3e} (tolerance {GMM_ATOL} + {GMM_RTOL} x score); DP EM (2 x 1) "
        f"over {r0['em_frames']} frames == one rank within {EM_RTOL} (largest relative error "
        f"{r0['em_err']:.2e})")
    say(f"exact partitioned beam (1 x 2, K=1024, R=64, root = branch hyps = 1024) on "
        f"{PARALLEL_BATCH} x {AUDIO_S:.0f} s: words == the single decode, scores within "
        f"{PART_RTOL} (max rel {r0['exact_rel']:.2e}); {audio16 / r0['exact_s']:.1f} audio-s/s "
        f"against the single decode's {audio16 / ref['exact']['wall']:.1f}; per-frame all_gather "
        f"of the [{PARALLEL_BATCH}, 1024, 4] int64 payload {r0['gather_ms']:.3f} ms (gloo, "
        f"{GATHER_REPS} timed)")
    say(f"production beam under partition (reported, not gated: per-slice limits prune "
        f"otherwise): {r0['production_agree']} of {PARALLEL_BATCH} utterances agree with the "
        f"single decode, word edit distance {r0['production_word_diff'][0]} over its "
        f"{r0['production_word_diff'][1]} words (random models: WER above 100%); {audio16 / r0['production_s']:.1f} audio-s/s against "
        f"{audio16 / ref['production']['wall']:.1f}")
    say(f"SpFrontend over {PARALLEL_WORLD} ranks on a {SP_SECONDS:.0f}-s recording "
        f"({r0['sp_frames']} frames) == FeatureFrontend (max abs err {r0['sp_err']:.3e}, "
        f"tolerance {FEAT_ATOL} + {FEAT_RTOL} x value), {r0['sp_s']:.2f} s; sp_viterbi_align == "
        f"viterbi_align ({SP_STATES} states: the same states, cost rel {r0['sp_vit_rel']:.2e}), "
        f"{r0['sp_vit_s']:.2f} s against {r0['vit_s']:.2f} s; dryrun_multichip(2) ok")

    # ---- the two examples, once each
    reset_counts()
    quiet = []
    t_a = time.time()
    demo = streaming_demo.run(dev, say=quiet.append)
    sweep = beam_sweep.run(dev, say=quiet.append)
    examples = read_counts("parallel phase (examples)", gmm_scores, mfcc_frames)
    say(f"examples in {time.time() - t_a:.1f} s: streaming_demo {demo['final'].orth!r} == offline; "
        f"beam_sweep WER " + ", ".join(f"K={k} {w:.4f}" for k, w in sweep["wers"].items()))
    total = {k: local[k] + examples[k] + sum(r["launches"][k] for r in ranks) for k in local}
    for k, v in total.items():
        if v < 1:
            raise AssertionError(f"the parallel phase never launched {k}")
    say(f"parallel phase {time.time() - t_phase:.1f} s, launches {total} (ranks "
        f"{[r['launches'] for r in ranks]})")
    return total


def parallel_rank(work: str, rank: int, world: int, init: str) -> None:
    """One gloo rank of the parallel phase (``--parallel-rank``), on card 0."""
    import numpy as np
    import torch

    t0 = time.time()
    sys.path.insert(0, HERE)
    from rasr_tpu_torch.corpus.bliss import CorpusDescription
    from rasr_tpu_torch.lattice.evaluator import align_tokens
    from rasr_tpu_torch.models.scorer import GmmFeatureScorer
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores
    from rasr_tpu_torch.ops.kernels.mfcc import mfcc_frames
    from rasr_tpu_torch.ops.viterbi import BIG, viterbi_align
    from rasr_tpu_torch.parallel import mesh as pm
    from rasr_tpu_torch.parallel.dryrun import dryrun_multichip
    from rasr_tpu_torch.parallel.sequence import SpFrontend, sp_viterbi_align
    from rasr_tpu_torch.parallel.sharded import ShardedGmmScorer, dp_accumulate, psum_counters
    from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
    from rasr_tpu_torch.pipeline.visitor import CorpusVisitor
    from rasr_tpu_torch.search.decoder import TreeDecoder
    from rasr_tpu_torch.synthetic import build_setup
    from rasr_tpu_torch.train.em import GmmAccumulator, accumulate

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pm.init_distributed("gloo", init, rank, world)
    with open(os.path.join(work, "inputs.json")) as fh:
        inputs = json.load(fh)
    s = build_setup(device=dev)
    dp, tp = pm.make_mesh(world, 1, device=dev), pm.make_mesh(1, world, device=dev)
    batch, em_batch, labels, recording, graph_ids = parallel_inputs(dev, s.tying.num_classes)
    out = dict(startup_s=time.time() - t0)

    def timed(fn):
        torch.cuda.synchronize()
        pm.all_reduce(torch.zeros(1, device=dev), dp, "data")  # start together
        t_a = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, time.time() - t_a

    # the DP recognizer and its merged WER counters
    corpus = CorpusDescription.load(inputs["corpus"])
    rec = OfflineRecognizer(s.frontend, s.scorer, s.decoder, mesh=dp)
    got, out["recognizer_s"] = timed(lambda: rec.run(CorpusVisitor(corpus,
                                                                  batch_size=RECOGNIZER_SEGMENTS)))
    if {r.segment_name: r.words for r in got} != inputs["single"]:
        raise AssertionError("the DP recognizer's words differ from the recognizer's")
    mine = rec.evaluator.total  # this rank's share of the segments
    out["counters"] = psum_counters(dp, np.array([[mine.errors, mine.reference_length]])).tolist()
    if out["counters"] != inputs["counts"]:
        raise AssertionError(f"merged WER counters {out['counters']} != {inputs['counts']}")

    # the TP scorer (mixtures over model) in min and LSE mode
    feats, _ = s.frontend(batch, torch.full((PARALLEL_BATCH,), batch.shape[1], device=dev))
    for key, mode in (("tp_err", True), ("tp_lse_err", False)):
        want = GmmFeatureScorer(s.mixtures, scale=s.scorer.scale, max_approx=mode, device=dev,
                                tensors=s.scorer.tensors)(feats)
        got_s = ShardedGmmScorer(s.mixtures, tp, scale=s.scorer.scale, max_approx=mode)(feats)
        out[key] = check_close(f"TP scorer (max_approx={mode})", got_s, want, GMM_RTOL, GMM_ATOL)

    # DP EM statistics over the 64 x 998 frames
    f64, _ = s.frontend(em_batch, torch.full((BATCH,), em_batch.shape[1], device=dev))
    x = f64.reshape(-1, f64.shape[-1])
    count, s1, s2 = dp_accumulate(dp, s.mixtures, x, labels)
    out["em_frames"] = x.shape[0]
    acc = accumulate(GmmAccumulator.zeros(*s.mixtures.means.shape), s.mixtures, x, labels)
    out["em_err"] = max(check_stats(f"DP EM {k}", a, b, EM_RTOL) for k, a, b in (
        ("count", count, acc.count), ("sum", s1, acc.sum), ("sumsq", s2, acc.sumsq)))

    # the partitioned beams against the single-rank decodes
    saved = torch.load(os.path.join(work, "emis.pt"))
    emis, n = saved["emis"].to(dev), saved["n"].to(dev)
    for label, cfg in (("exact", exact_beam()), ("production", s.beam)):
        dec = TreeDecoder(s.tree, s.decoder.lm, cfg, tables=s.decoder.tables, device=dev)
        res, out[f"{label}_s"] = timed(lambda: dec.decode_scores(emis, n, mesh=tp,
                                                                 beam_axis="model"))
        want = inputs["decodes"][label]
        agree = [r.words == w for r, w in zip(res, want["words"])]
        out[f"{label}_agree"] = sum(agree)
        out[f"{label}_word_diff"] = [sum(align_tokens(w, r.words)[0].errors
                                         for r, w in zip(res, want["words"])),
                                     sum(len(w) for w in want["words"])]
        if label == "exact":
            rel = [abs(r.score - w) / max(abs(w), 1.0) for r, w in zip(res, want["scores"])]
            out["exact_rel"] = max(rel)
            if not all(agree) or max(rel) > PART_RTOL:
                raise AssertionError(f"exact partitioned beam != single decode: "
                                     f"{sum(agree)} of {len(agree)} agree, rel {max(rel):.2e}")
    # each rank's local top-K: (state, LM state, score bits, backpointer)
    payload = torch.zeros((PARALLEL_BATCH, 1024, 4), dtype=torch.int64, device=dev)
    _, t_g = timed(lambda: [pm.all_gather(payload, tp, "model", dim=1) for _ in range(GATHER_REPS)])
    out["gather_ms"] = t_g / GATHER_REPS * 1e3

    # sequence parallelism on the long recording
    lengths = torch.full((1,), recording.shape[1], device=dev)
    sp = SpFrontend(s.frontend, dp)
    (chunk, n_sp), out["sp_s"] = timed(lambda: sp(recording, lengths))
    dense, n_dense = s.frontend(recording, lengths)
    T = dense.shape[1]
    base = pm.axis_index(dp, "data") * chunk.shape[1]
    hi = min(base + chunk.shape[1], T)
    if not torch.equal(n_sp, n_dense) or bool(chunk[:, hi - base:].any()):
        raise AssertionError("SpFrontend: frame counts or the padding past the end differ")
    out["sp_err"] = check_close("SpFrontend chunk", chunk[:, : hi - base], dense[:, base:hi],
                                FEAT_RTOL, FEAT_ATOL)
    out["sp_frames"] = T
    eids = torch.as_tensor(graph_ids, device=dev)
    vemis = s.scorer(dense)[:, :, eids]
    S = SP_STATES
    costs = [torch.full((S,), v, device=dev) for v in (0.5, 0.0, 2.0, BIG, BIG)]
    costs[3][0] = 0.0  # loop, forward, skip; init at the first state
    costs[4][-1] = 0.0  # final at the last
    (best_sp, states_sp), out["sp_vit_s"] = timed(
        lambda: sp_viterbi_align(dp, vemis, *costs, n_dense))
    (best, states), out["vit_s"] = timed(lambda: viterbi_align(vemis, *costs, n_dense))
    if not torch.equal(states_sp, states):
        raise AssertionError("sp_viterbi_align's states differ from viterbi_align's")
    out["sp_vit_rel"] = float(((best_sp - best).abs() / best.abs().clamp(min=1.0)).max())
    if out["sp_vit_rel"] > PART_RTOL:
        raise AssertionError(f"sp_viterbi_align's cost off by {out['sp_vit_rel']:.2e}")

    dryrun_multichip(world, device=dev)
    out["launches"] = {fn.__name__: fn.launches for fn in (gmm_scores, mfcc_frames)}
    print("PARALLEL-RANK " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device visible\n")
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from rasr_tpu_torch import _build, bench
    from rasr_tpu_torch.corpus.audio import write_wav
    from rasr_tpu_torch.corpus.bliss import CorpusDescription
    from rasr_tpu_torch.device import card_tag, cuda_device, cuda_graph_ms, cuda_ms
    from rasr_tpu_torch.examples import gather_microbench, streaming_bench, wordend_microbench
    from rasr_tpu_torch.lattice.evaluator import lattice_oracle
    from rasr_tpu_torch.lattice.lattice import Lattice, decoder_lattice
    from rasr_tpu_torch.models.gmm import MixtureSet, make_scoring_tensors
    from rasr_tpu_torch.models.lm.ngram import compile_ngram
    from rasr_tpu_torch.models.nn import (
        ConformerEncoderNet, NnHybridScorer, StatePriors, conformer_flop,
    )
    from rasr_tpu_torch.ops.frontend import (
        FrontendConfig, frame_signal, make_params, num_frames, preemphasize,
    )
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores, gmm_scores_plain
    from rasr_tpu_torch.ops.kernels.mfcc import (
        folded_bases, mfcc_frames, mfcc_frames_plain, pack_basis,
    )
    from rasr_tpu_torch.ops.kernels.row_gather import row_gather, row_gather_plain
    from rasr_tpu_torch.ops.kernels.wordend import WORD_NONE, wordend_block, wordend_block_plain
    from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
    from rasr_tpu_torch.pipeline.visitor import CorpusVisitor
    from rasr_tpu_torch.search.decoder import TreeDecoder, traceback
    from rasr_tpu_torch.synthetic import CONFORMER, PATHS, SLICE_A_BEAM, build_setup
    from rasr_tpu_torch.utils import native
    from rasr_tpu_torch.utils.archive import FileArchive

    dev = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card_tag()
    device_name = torch.cuda.get_device_name(0)
    counted = (gmm_scores, mfcc_frames, wordend_block, row_gather)

    def say(msg):
        print(f"[{tag}] {msg}", flush=True)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts(path, *kernels):
        counts = {fn.__name__: fn.launches for fn in kernels}
        for k, v in counts.items():
            if v < 1:
                raise AssertionError(f"the {path} never launched {k}")
        return counts

    t0 = time.time()
    _build.library()
    say(f"kernel build {time.time() - t0:.2f} s (one nvcc per source, in parallel)")
    t0 = time.time()
    if native.load_native() is None:
        raise AssertionError(f"the native host library did not load: {native.build_error}")
    say(f"native host library {native.library_path().name}: {time.time() - t0:.2f} s (g++ "
        f"of native/arpa.cc and native/rtar.cc)")
    for line in _build.build_log.splitlines():  # ptxas: registers, spills, shared memory
        if any(k in line for k in ("Compiling entry", "spill", "registers")):
            say("ptxas " + line.split(":", 1)[-1].strip())

    # ------------------------------------------------------------ setup
    t0 = time.time()
    s = build_setup(device=dev)
    say(f"setup {time.time() - t0:.1f} s: tree {s.tree.stats()}")
    rng = np.random.default_rng(1)
    S = int(AUDIO_S * 16000)
    samples = torch.from_numpy((rng.normal(size=(BATCH, S)) * 0.1).astype(np.float32)).to(dev)
    lengths = torch.full((BATCH,), S, dtype=torch.int64, device=dev)
    cfg = FrontendConfig()
    T = num_frames(S, cfg)
    N = BATCH * T

    # ------------------------------------------- kernel phase: GMM scoring
    st = s.scorer.tensors
    feats = torch.from_numpy(rng.normal(size=(N, st.dim)).astype(np.float32)).to(dev)
    def ragged_case(N_, M_, K_, D_):
        """Frames and mixtures off their tiles, K_ with padding densities."""
        ms = MixtureSet(
            means=rng.normal(size=(M_, K_, D_)).astype(np.float32),
            variances=(0.5 + rng.uniform(size=(M_, K_, D_))).astype(np.float32),
            weights=np.full((M_, K_), 1.0 / K_, np.float32),
            num_densities=rng.integers(1, K_ + 1, size=M_).astype(np.int32),
        )
        ms.weights[ms.density_mask == 0] = 0.0
        x_ = torch.from_numpy(rng.normal(size=(N_, D_)).astype(np.float32)).to(dev)
        return x_, make_scoring_tensors(ms, device=dev)

    gmm_err = 0.0
    # the main path's N (one mixture-tile group per frame block), a slice of
    # it (nine groups: the launcher splits the mixtures when N is small),
    # ragged at D = 39, and D = 96 (too deep for a resident frame tile: the
    # frames stream through the ring with the operand)
    for x_, st_ in ((feats, st), (feats[:4096], st), ragged_case(4097, 1999, 3, 39),
                    ragged_case(1000, 300, 2, 96)):
        for max_approx in (True, False):
            before = gmm_scores.launches
            got = gmm_scores(x_, st_, max_approx)
            torch.cuda.synchronize()
            if gmm_scores.launches <= before:
                raise AssertionError("gmm_scores did not launch its kernel")
            ref = gmm_scores_plain(x_, st_, max_approx)
            gmm_err = max(gmm_err, check_close(
                f"gmm N={x_.shape[0]} M={st_.num_mixtures} K={st_.max_densities} "
                f"D={st_.dim} max_approx={max_approx}", got, ref, GMM_RTOL, GMM_ATOL))
    del got, ref, x_, st_
    gmm_ms = cuda_ms(lambda: gmm_scores(feats, st, True), 5)
    gmm_plain_ms = cuda_ms(lambda: gmm_scores_plain(feats, st, True), 5)
    xx, ab = torch.cat([feats * feats, feats], 1), torch.cat([st.a, st.b], 0)
    gmm_lib_ms = cuda_ms(lambda: torch.matmul(xx, ab), 3)  # the bare density product
    del xx, ab
    M_, K_, D_ = st.num_mixtures, st.max_densities, st.dim
    gmm_flop, gmm_bytes = 4.0 * N * D_ * M_ * K_, 4.0 * (N * D_ + (2 * D_ + 1) * M_ * K_ + N * M_)
    gmm_bound = bound(0.0, gmm_bytes, gmm_flop)
    say(f"gmm_scores N={N} M={M_} K={K_} D={D_}: kernel {gmm_ms:.3f} ms, plain "
        f"{gmm_plain_ms:.3f} ms, matmul([x^2|x], [a;b]) {gmm_lib_ms:.3f} ms, bound "
        f"{gmm_bound[0]:.3f} ms ({gmm_bound[1]}, 3xTF32; on the fp32 pipes "
        f"{bound(gmm_flop, gmm_bytes)[0]:.3f} ms), max abs err {gmm_err:.3e}")
    del feats

    # ------------------------------------------------ kernel phase: MFCC
    p = s.frontend.params
    cosw, sinw = folded_bases(p)
    frames = frame_signal(preemphasize(samples, cfg.preemphasis), T, cfg)
    mfcc_err = 0.0
    # the main path's frames; 3 utterances of 37 frames (one tile crosses two
    # utterance boundaries), with a near-silent stretch; 8 kHz frames (L = 200);
    # 40 mel bands (two band groups)
    cases = [(cfg, frames)]
    for cfg_, B_, S_ in ((cfg, 3, 6160), (FrontendConfig(sample_rate=8000), 3, 3000),
                         (FrontendConfig(num_mel=40), 2, 4321)):
        sig = torch.from_numpy((rng.normal(size=(B_, S_)) * 0.1).astype(np.float32)).to(dev)
        sig[:, : S_ // 3] *= 0.01
        cases.append((cfg_, frame_signal(preemphasize(sig, cfg_.preemphasis),
                                         num_frames(S_, cfg_), cfg_)))
    for cfg_, fr in cases:
        p_ = make_params(cfg_, dev)
        args = (fr, *folded_bases(p_), p_.mel, p_.dct, cfg_.log_floor)
        before = mfcc_frames.launches
        got = mfcc_frames(*args, pack_basis(*folded_bases(p_)))
        torch.cuda.synchronize()
        if mfcc_frames.launches <= before:
            raise AssertionError("mfcc_frames did not launch its kernel")
        mfcc_err = max(mfcc_err, check_close(
            f"mfcc {tuple(fr.shape)} at {cfg_.sample_rate} Hz", got,
            mfcc_frames_plain(*args), MFCC_RTOL, MFCC_ATOL))
    args = (frames, cosw, sinw, p.mel, p.dct, cfg.log_floor)
    basis = pack_basis(cosw, sinw)
    mfcc_ms = cuda_ms(lambda: mfcc_frames(*args, basis), 10)
    mfcc_plain_ms = cuda_ms(lambda: mfcc_frames_plain(*args), 10)
    cs = torch.cat([cosw, sinw], 1)
    mfcc_lib_ms = cuda_ms(lambda: torch.matmul(frames, cs), 10)  # the DFT product alone
    L_, bins_ = cosw.shape
    mel_, ceps_ = p.dct.shape
    dft_flop, rest_flop = N * 4.0 * L_ * bins_, N * (2.0 * bins_ * mel_ + 2.0 * mel_ * ceps_)
    mfcc_bytes = 4.0 * (BATCH * ((T - 1) * cfg.frame_shift + L_) + 2 * L_ * bins_
                        + bins_ * mel_ + mel_ * ceps_ + N * ceps_)
    mfcc_bound = bound(rest_flop, mfcc_bytes, dft_flop)  # the DFT on the tensor cores
    say(f"mfcc_frames N={N} L={L_}: kernel {mfcc_ms:.3f} ms, plain {mfcc_plain_ms:.3f} ms, "
        f"matmul(frames, [cosw|sinw]) {mfcc_lib_ms:.3f} ms, bound {mfcc_bound[0]:.4f} ms "
        f"({mfcc_bound[1]}, 3xTF32 DFT; on the fp32 pipes "
        f"{bound(dft_flop + rest_flop, mfcc_bytes)[0]:.4f} ms), max abs err {mfcc_err:.3e}")
    del frames, got, cases

    # ------------------- kernel phase: word-end block and row gather, ragged
    for shape in (dict(B=3, KW=1000, S1=5003, C=1999, C_sp=12),
                  dict(B=5, KW=7, S1=11, C=3, C_sp=5)):
        w_state, w_score, combo, emis = wordend_microbench.make_inputs(**shape)
        combo[w_state[0, 0], 0] = WORD_NONE
        args = [torch.from_numpy(x).to(dev) for x in (w_state, w_score, combo, emis)]
        before = wordend_block.launches
        got = wordend_block(*args, shape["C_sp"])
        torch.cuda.synchronize()
        if wordend_block.launches != before + 1:
            raise AssertionError("wordend_block did not launch its kernel")
        check_equal(f"wordend_block {shape}", got, wordend_block_plain(*args, shape["C_sp"]))
    for S_, C_, N_ in ((56432, 16, 65536), (1000, 5, 777), (300, 8, 1)):
        table, idx = (torch.from_numpy(x).to(dev)
                      for x in gather_microbench.make_inputs(S_, C_, N_, seed=C_))
        before = row_gather.launches
        got = row_gather(table, idx)
        torch.cuda.synchronize()
        if row_gather.launches != before + 1:
            raise AssertionError("row_gather did not launch its kernel")
        check_equal(f"row_gather S={S_} C={C_} N={N_}", [got], [row_gather_plain(table, idx)])
    say("wordend_block and row_gather bit-equal to their plain versions at ragged shapes")

    # ----------------- the microbench paths (their own entry points)
    reset_counts()
    we_run = wordend_microbench.run(dev)
    we_launches = read_counts("word-end microbench", wordend_block)
    reset_counts()
    ga_run = gather_microbench.run(dev)
    ga_launches = read_counts("gather microbench", row_gather)
    for path, run in (("word-end", we_run), ("gather", ga_run)):
        if not run["correct"]:
            raise AssertionError(f"{path} microbench: kernel differs from its plain version")
    # their bounds: the bytes these inputs need (rows and emissions gathered once)
    w_state, _, combo, _ = wordend_microbench.make_inputs(**wordend_microbench.SHAPE)
    slots, c_sp = w_state.size, wordend_microbench.SHAPE["C_sp"]
    states = np.unique(w_state)
    emis_cells = np.unique(np.arange(w_state.shape[0])[:, None] * wordend_microbench.SHAPE["C"]
                           + combo[w_state, 4]).size
    we_bound = bound(2.0 * slots, 4.0 * (2 * slots + states.size * (5 + c_sp) + emis_cells
                                         + slots * (5 + c_sp)))
    table, idx = (torch.from_numpy(x).to(dev)
                  for x in gather_microbench.make_inputs(**gather_microbench.SHAPE))
    rows, width = idx.numel(), table.shape[1]
    ga_bound = bound(0.0, 4.0 * (torch.unique(idx).numel() * width + rows + rows * width))
    ga_lib_ms = cuda_graph_ms(lambda: torch.index_select(table, 0, idx), gather_microbench.REPS)
    say(f"wordend_block {wordend_microbench.SHAPE}: device time kernel {we_run['ms']:.4f} ms, "
        f"plain {we_run['plain_ms']:.4f} ms, bound {we_bound[0]:.4f} ms ({we_bound[1]}); "
        f"per eager call {we_run['eager_ms']:.4f} ms, plain {we_run['plain_eager_ms']:.4f} ms; "
        f"launches {we_launches}")
    say(f"row_gather {gather_microbench.SHAPE}: device time kernel {ga_run['ms']:.4f} ms "
        f"({ga_run['ns_per_row']:.3f} ns/row), plain {ga_run['plain_ms']:.4f} ms, "
        f"index_select {ga_lib_ms:.4f} ms, bound {ga_bound[0]:.4f} ms ({ga_bound[1]}); "
        f"per eager call {ga_run['eager_ms']:.4f} ms, plain {ga_run['plain_eager_ms']:.4f} ms; "
        f"launches {ga_launches}")

    # ------------------------- planted canary under both bench.py configs
    bench.planted_canary(dev)
    say("canary ok: [SILENCE] AB @ [1, 5] (plain + rsel/defer/caps; within-word + across-word)")

    # ------------------------------------------------------ decode paths
    def run_batch(decoder, x, n, su=s):
        t_a = time.time()
        f, nf = su.frontend(x, n)
        torch.cuda.synchronize()
        t_b = time.time()
        e = su.scorer(f)
        torch.cuda.synchronize()
        t_c = time.time()
        results = decoder.results_from_device(decoder.decode_scores_device(e, nf))
        t_d = time.time()
        return f, e, nf, results, np.array([t_b - t_a, t_c - t_b, t_d - t_c])

    def check_outputs(f, e, nf, results, B):
        D = s.frontend.output_dim
        if tuple(f.shape) != (B, T, D) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"features: shape {tuple(f.shape)} or non-finite")
        if tuple(e.shape) != (B, T, st.num_mixtures) or not bool(torch.isfinite(e).all()):
            raise AssertionError(f"emissions: shape {tuple(e.shape)} or non-finite")
        if not bool((nf == T).all()):
            raise AssertionError("frame counts disagree with the audio length")
        if len(results) != B or not all(np.isfinite(r.score) and r.words for r in results):
            raise AssertionError("decode produced an empty or non-finite result")

    def report(label, stage, batches, B, counts, peak=None):
        fe_s, sc_s, dec_s = stage / batches
        say(f"{label} B={B} x {AUDIO_S:g} s ({T} frames), per batch: frontend "
            f"{fe_s * 1e3:.1f} ms, scorer {sc_s * 1e3:.1f} ms, decode {dec_s * 1e3:.1f} ms")
        extra = f"; peak device memory {peak / 2**30:.2f} GiB" if peak is not None else ""
        say(f"{label} throughput {batches * B * AUDIO_S / stage.sum():.1f} audio-s/s; "
            f"launches {counts}{extra}")

    # main path: full width, bench.py's production beam
    run_batch(s.decoder, samples, lengths)  # warm-up: cuBLAS handles, allocator, first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    stage = np.zeros(3)
    for _ in range(TIMED_BATCHES):
        f, e, nf, results, dt = run_batch(s.decoder, samples, lengths)
        stage += dt
    launches = read_counts("main path", gmm_scores, mfcc_frames)
    by_path = {"main": launches}  # each path's launches, for the kernels line
    peak = torch.cuda.max_memory_allocated(dev)
    check_outputs(f, e, nf, results, BATCH)
    report("main path (production beam)", stage, TIMED_BATCHES, BATCH, launches, peak)
    main_rate = TIMED_BATCHES * BATCH * AUDIO_S / stage.sum()
    say(f"sample: {results[0].orth[:80]!r} score {results[0].score:.3f}")
    # the best-path read of a decoded batch, warm: the device walk and its
    # one payload (the walk alone in CUDA events)
    handle = s.decoder.decode_scores_device(e, nf)
    torch.cuda.synchronize()
    read_s = []
    for _ in range(5):
        t_a = time.time()
        again = s.decoder.results_from_device(handle)
        read_s.append(time.time() - t_a)
    if [r.words for r in again] != [r.words for r in results]:
        raise AssertionError("a second decode of the batch read other words")
    walk_ms = cuda_ms(lambda: traceback(handle), 5)
    say(f"results_from_device warm (B={BATCH}, {T} frames, {len(read_s)} reads): median "
        f"{np.median(read_s) * 1e3:.2f} ms, min {min(read_s) * 1e3:.2f} ms; the walk "
        f"{walk_ms:.2f} ms (CUDA events, 5 calls); payload {tuple(traceback(handle).shape)} "
        f"int32; longest chain {max(len(r.record_ids) for r in results)} word ends")
    del f, e, results, handle, again

    # slice A: the same setup without the slice-B pruning, reduced depth
    dec_a = TreeDecoder(s.tree, compile_ngram(s.lm), SLICE_A_BEAM, device=dev)
    xa, na = samples[:SLICE_A_BATCH], lengths[:SLICE_A_BATCH]
    run_batch(dec_a, xa[:, :16000], torch.full_like(na, 16000))  # warm-up on 1 s, as the main path's
    reset_counts()
    f, e, nf, results, stage = run_batch(dec_a, xa, na)
    launches_a = read_counts("slice A path", gmm_scores, mfcc_frames)
    by_path["slice A"] = launches_a
    check_outputs(f, e, nf, results, SLICE_A_BATCH)
    report("slice A", stage, 1, SLICE_A_BATCH, launches_a)
    del f, e, results

    # --------- slice C: the across-word network, the 4-gram LM, lookahead
    c_setups = {}
    for label, (B_, full_warmup) in SLICE_C.items():
        t0 = time.time()
        sc = build_setup(device=dev, **PATHS[label])
        setup_s = time.time() - t0
        bla = sc.bigram_la
        say(f"{label} setup {setup_s:.1f} s: network {sc.tree.num_states} states, max branch "
            f"degree {sc.decoder.tables.branch_degree}, wmax {sc.tree.max_word_ends}, "
            f"{sc.decoder.lm.num_states} LM states, branch_width {sc.beam.branch_width}, "
            f"lookahead update {sc.beam.lookahead_update!r}; lookahead {bla.num_subtrees} "
            f"nodes, {bla.num_classes} classes, corr table {bla.corr.nbytes / 1e6:.1f} MB"
            f"{'' if bla.dpair is None else f', dpair {bla.dpair.nbytes / 1e6:.1f} MB'}")
        xc, nc = samples[:B_], lengths[:B_]
        if full_warmup:
            run_batch(sc.decoder, xc, nc, sc)
        else:
            run_batch(sc.decoder, xc[:, :16000], torch.full_like(nc, 16000), sc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        f, e, nf, results, stage = run_batch(sc.decoder, xc, nc, sc)
        counts = read_counts(f"{label} path", gmm_scores, mfcc_frames)
        by_path[label] = counts
        peak = torch.cuda.max_memory_allocated(dev)
        check_outputs(f, e, nf, results, B_)
        report(f"{label} path", stage, 1, B_, counts, peak)
        say(f"{label} sample: {results[0].orth[:80]!r} score {results[0].score:.3f}")
        c_setups[label] = sc
        del f, e, results

    # ------------- the conformer hybrid path (bench.py's BENCH_SCORER=conformer)
    t0 = time.time()
    sn = build_setup(device=dev, **PATHS["conformer"])
    nn_setup_s = time.time() - t0
    net = sn.scorer.model
    if sn.tree.num_states != s.tree.num_states or sn.decoder.lm.num_states != s.decoder.lm.num_states:
        raise AssertionError("the conformer setup drew another network or LM than the main path")
    say(f"conformer setup {nn_setup_s:.1f} s: {sum(p.numel() for p in net.parameters())} "
        f"parameters ({CONFORMER}, compute dtype {net.cdt}); the main path's network and LM")
    run_batch(sn.decoder, samples, lengths, sn)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    f, e, nf, results, stage = run_batch(sn.decoder, samples, lengths, sn)
    nn_launches = read_counts("conformer path", mfcc_frames)
    by_path["conformer"] = nn_launches
    peak = torch.cuda.max_memory_allocated(dev)
    check_outputs(f, e, nf, results, BATCH)
    report("conformer path", stage, 1, BATCH, nn_launches, peak)
    say(f"conformer sample: {results[0].orth[:80]!r} score {results[0].score:.3f}")
    nn_ms = cuda_ms(lambda: sn.scorer(f), 3)
    flop16, flop32 = (BATCH * T * x for x in conformer_flop(CONFORMER, f.shape[-1],
                                                             sn.scorer.num_classes, T))
    nn_bytes = 4.0 * (sum(p.numel() for p in net.parameters()) + f.numel() + e.numel())
    nn_bound = max(flop16 / BF16_FLOPS, flop32 / FP32_FLOPS, nn_bytes / HBM_BYTES_S) * 1e3
    all_bf16 = (flop16 + flop32) / BF16_FLOPS * 1e3
    say(f"conformer scorer B={BATCH} x {T} frames: {nn_ms:.3f} ms on the card (CUDA events, 3 "
        f"calls); bound {nn_bound:.3f} ms (operations: {flop16:.3e} bf16 FLOP at 989 TFLOP/s "
        f"beside {flop32:.3e} float32 FLOP of the attention-value product at 67 TFLOP/s), "
        f"share {nn_bound / nn_ms:.1%}; at 989 TFLOP/s for all {flop16 + flop32:.3e} FLOP "
        f"{all_bf16:.3f} ms, share {all_bf16 / nn_ms:.1%}")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        sn.scorer(f)
        torch.cuda.synchronize()
    kernels = sorted(((getattr(k, "device_time_total", 0.0), k.key) for k in prof.key_averages()),
                     reverse=True)
    total_us = max(sum(t for t, _ in kernels), 1e-9)
    say(f"conformer scorer under torch.profiler: {total_us / 1e3:.1f} ms of device time; top: "
        + "; ".join(f"{name[:60]} {t / 1e3:.1f} ms ({t / total_us:.0%})" for t, name in kernels[:8]))
    del f, e, results

    # ---------- the streaming path: the main path's decoder, fed in blocks
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    stream_rows = streaming_bench.run(dev, s)
    stream_launches = read_counts("streaming path", gmm_scores, mfcc_frames)
    by_path["streaming"] = stream_launches
    peak = torch.cuda.max_memory_allocated(dev)
    for row in stream_rows:
        say(f"streaming block {row['block_frames']}: {row['audio_s_per_s']:.1f} audio-s/s "
            f"(offline {row['offline_audio_s_per_s']:.1f}), per feed {row['per_feed_ms']:.2f} ms "
            f"(synced p50 {row['per_feed_ms_synced_p50']:.2f}, p95 "
            f"{row['per_feed_ms_synced_p95']:.2f}; budget {row['feed_budget_ms']:.0f}), "
            f"current_best {row['current_best_ms_warm']:.2f} ms warm; streamed == offline")
    say(f"streaming launches {stream_launches}; peak device memory {peak / 2**30:.2f} GiB")

    # ------------ the recognizer path: a corpus on disk, best-only and with lattices
    corpus_dir = tempfile.TemporaryDirectory()
    words = [lemma.primary_orth for lemma in s.lexicon.lemmata if not lemma.special]
    xml, audio_total = ['<corpus name="smoke">'], 0.0
    for i, dur in enumerate(rng.uniform(3.0, 10.0, size=RECOGNIZER_SEGMENTS)):
        wav = os.path.join(corpus_dir.name, f"r{i}.wav")
        write_wav(wav, (rng.normal(size=int(dur * 16000)) * 0.1).astype(np.float32))
        audio_total += int(dur * 16000) / 16000
        orth = " ".join(rng.choice(words, size=int(rng.integers(2, 13))))
        xml.append(f'<recording name="r{i}" audio="{wav}"><segment name="s">'
                   f'<speaker name="spk{i % RECOGNIZER_SPEAKERS}"/><orth>{orth}</orth>'
                   f"</segment></recording>")
    corpus_path = os.path.join(corpus_dir.name, "smoke.corpus")
    with open(corpus_path, "w") as fh:
        fh.write("".join(xml) + "</corpus>")
    corpus = CorpusDescription.load(corpus_path)
    lat_path = os.path.join(corpus_dir.name, "lattices")
    rec_runs = {}
    for label, kw in (("best-only", {}),
                      ("lattices + CTM", dict(lattice_archive=lat_path,
                                              ctm_file=os.path.join(corpus_dir.name, "ctm")))):
        recognizer = OfflineRecognizer(s.frontend, s.scorer, s.decoder, **kw)
        torch.cuda.synchronize()
        reset_counts()
        t_a = time.time()
        rec_results = recognizer.run(CorpusVisitor(corpus, batch_size=RECOGNIZER_SEGMENTS))
        wall = time.time() - t_a
        counts = read_counts(f"recognizer path ({label})", gmm_scores, mfcc_frames)
        by_path[f"recognizer ({label})"] = counts
        rec_runs[label] = {r.segment_name: r for r in rec_results}
        say(f"recognizer ({label}): {len(rec_results)} segments, {audio_total:.1f} audio-s in "
            f"{wall:.2f} s: {audio_total / wall:.1f} audio-s/s; WER "
            f"{recognizer.evaluator.report()['wer']:.3f} (random models); launches {counts}")
    if [r.words for r in rec_runs["best-only"].values()] != [
            r.words for r in rec_runs["lattices + CTM"].values()]:
        raise AssertionError("the recognizer's two runs read other words")
    # the same batch through the decoder directly: the same words; its
    # handle's record pull and the host lattice builds, timed
    (batch,) = list(CorpusVisitor(corpus, batch_size=RECOGNIZER_SEGMENTS).batches())
    fb, nb = s.frontend(batch.samples, batch.lengths)
    handle = s.decoder.decode_scores_device(s.scorer(fb), nb)
    direct = s.decoder.results_from_device(handle, batch.names)
    for r in direct:
        got = rec_runs["best-only"][r.segment_name]
        if got.words != r.words or got.score != r.score:
            raise AssertionError(f"recognizer vs decode_scores ({r.segment_name}): {got.words} "
                                 f"{got.score} vs {r.words} {r.score}")
    t_a = time.time()
    host = handle.records_to_host()
    pull_ms = (time.time() - t_a) * 1e3
    pulled_mb = sum(x.nbytes for x in host.records + host.finals) / 1e6
    t_a = time.time()
    lattices = [decoder_lattice(handle, s.tree.lemmas, b) for b in range(len(direct))]
    build_ms = (time.time() - t_a) * 1e3
    t_a = time.time()
    complete = ((handle.finals.fstate < handle.num_final_states)
                & (handle.finals.fscore < 1e29)).any(dim=1).tolist()
    checked = 0
    for lat, r, done in zip(lattices, direct, complete):
        if done and r.record_ids:
            errors = lattice_oracle(lat, r.words)[0]
            if errors:
                raise AssertionError(f"lattice of {r.segment_name} misses its best path "
                                     f"({errors} oracle errors)")
            checked += 1
    oracle_s = time.time() - t_a
    if not checked:
        raise AssertionError("no lattice holds a complete best path")
    with FileArchive(lat_path, "r") as ar:
        if sorted(ar.keys()) != sorted(batch.names):
            raise AssertionError("the lattice archive lacks segments")
        for seg_name, lat in zip(batch.names, lattices):
            back = Lattice.unpack(ar.read(seg_name))
            if (back.num_nodes, back.node_time.tolist(), sorted(back.final_scores)) != (
                    lat.num_nodes, lat.node_time.tolist(), sorted(lat.final_scores)) or [
                    (a.from_node, a.to_node, a.lemma) for a in back.arcs] != [
                    (a.from_node, a.to_node, a.lemma) for a in lat.arcs]:
                raise AssertionError(f"archived lattice of {seg_name} differs from the built one")
            check_close(f"archived lattice scores of {seg_name}",
                        torch.tensor([(a.am_score, a.lm_score) for a in back.arcs]).reshape(-1, 2),
                        torch.tensor([(a.am_score, a.lm_score) for a in lat.arcs]).reshape(-1, 2),
                        1e-6, 0.0)
    arcs = [len(lat.arcs) for lat in lattices]
    say(f"recognizer == decode_scores on {len(direct)} segments; record pull {pull_ms:.1f} ms "
        f"({pulled_mb:.1f} MB), host lattice build {build_ms:.1f} ms per batch of "
        f"{len(direct)} (arcs per lattice median {int(np.median(arcs))}, max {max(arcs)}); "
        f"oracle WER 0 on {checked} lattices ({oracle_s:.1f} s); archive round trip equal")
    del handle, host, lattices

    # ----------- fMLLR: speaker transforms estimated and fed to the recognizer
    fmllr_launches = fmllr_phase(s, dev, corpus, batch, fb, nb, rec_runs["best-only"], say,
                                 reset_counts, read_counts)

    # -------- rnn-fusion: the neural LM in the first pass, and the second pass
    t_a = time.time()
    rnn_launches = rnn_fusion_phase(s, dev, samples, lengths, corpus, batch, fb, nb, main_rate,
                                    rng, say, reset_counts, read_counts)
    say(f"rnn-fusion phase {time.time() - t_a:.1f} s, launches {rnn_launches}")

    # ---------- the tools as processes, the packed LM, a class LM
    tools_launches = tools_phase(s, dev, corpus_path, c_setups["4-gram"], samples, lengths, say,
                                 reset_counts, read_counts)

    # ---- the parallel layer: DP, TP, the partitioned beam, sequence parallelism
    by_path["parallel"] = parallel_phase(s, dev, corpus, corpus_path, rec_runs["best-only"],
                                         audio_total, say, reset_counts, read_counts)
    corpus_dir.cleanup()
    del fb

    # --------------------------------- the bench path: python -m rasr_tpu_torch.bench
    reset_counts()
    out = io.StringIO()
    t_a = time.time()
    with contextlib.redirect_stderr(io.StringIO()) as err:
        record_b = bench.run(dev, out=out, windows=BENCH_WINDOWS, iters=BENCH_ITERS)
    bench_launches = read_counts("bench path", gmm_scores, mfcc_frames)
    by_path.update({"fmllr recognizer": fmllr_launches, "rnn-fusion": rnn_launches,
                    "tools": tools_launches, "bench": bench_launches})
    for line in err.getvalue().splitlines():
        say(line)
    say(f"bench entry {time.time() - t_a:.1f} s, launches {bench_launches}: "
        f"{out.getvalue().strip()}")
    if record_b["metric"] != "torch_decode_throughput" or not record_b["value"] > 0:
        raise AssertionError(f"bench entry: {record_b}")

    # ----------------------- the training side: alignment, EM, LDA, NN training
    align_launches, em_model, align_graphs = align_em_phase(
        s, dev, samples, lengths, rng, say, reset_counts, read_counts)
    _, ce_launches = train_ce_phase(dev, rng, say, reset_counts, counted)
    _, lfmmi_launches = train_lfmmi_phase(s, dev, rng, say, reset_counts, counted)
    say(f"launches on the training-side paths: align-em {align_launches}, fmllr recognizer "
        f"{fmllr_launches}, train-ce {ce_launches}, train-lfmmi {lfmmi_launches}")

    # ------------- the other front ends, VTLN, and WFST grammar networks
    t_a = time.time()
    ext_err, ext_launches = frontend_ext_phase(s, dev, samples, lengths, em_model, align_graphs,
                                               say, reset_counts, read_counts)
    say(f"frontend-ext phase {time.time() - t_a:.1f} s, launches {ext_launches}")
    t_a = time.time()
    wfst_launches = wfst_phase(s, dev, samples, lengths, rng, say, reset_counts, read_counts)
    say(f"wfst phase {time.time() - t_a:.1f} s, launches {wfst_launches}")
    by_path.update({"align-em": align_launches, "train-ce": ce_launches,
                    "train-lfmmi": lfmmi_launches, "frontend-ext": ext_launches,
                    "wfst": wfst_launches, "word-end microbench": we_launches,
                    "gather microbench": ga_launches})

    def paths_of(name):
        """``name``'s launches on every path that read its count."""
        return {path: c[name] for path, c in by_path.items() if name in c}

    # --------------------- CUDA decode == CPU decode, every beam and path
    small = int(3.0 * 16000)
    x2 = samples[:2, :small]
    f2, nf2 = s.frontend(x2, torch.full((2,), small, device=dev))
    e2 = s.scorer(f2)
    s_cpu = build_setup(device="cpu")
    f2c, _ = s_cpu.frontend(x2.cpu(), torch.full((2,), small))
    check_close("features cuda vs cpu", f2.cpu(), f2c, 1e-3, 1e-3)
    check_close("emissions cuda vs cpu", e2.cpu(), s_cpu.scorer(f2c), 1e-4, 1e-2)
    dec_a_cpu = TreeDecoder(s_cpu.tree, compile_ngram(s_cpu.lm), SLICE_A_BEAM,
                            device="cpu")
    pairs = [("production", s.decoder, s_cpu.decoder, e2, nf2),
             ("slice A", dec_a, dec_a_cpu, e2, nf2)]
    for label, sc in c_setups.items():
        # the path's network, LM and lookahead, built once, decoded on the
        # CPU too (the 4-gram setup draws other GMMs: its own scores)
        fc, nfc = sc.frontend(x2, torch.full((2,), small, device=dev))
        pairs.append((label, sc.decoder, TreeDecoder(
            sc.tree, compile_ngram(sc.lm), sc.beam, bigram_la=sc.bigram_la, device="cpu"),
            sc.scorer(fc), nfc))
    # the conformer: its float32 twin on the card against the CPU, the bf16
    # network against that twin, then the decode of the bf16 emissions
    fn2, nfn2 = sn.frontend(x2, torch.full((2,), small, device=dev))
    priors = StatePriors(sn.scorer.log_priors.cpu().numpy())
    twins = [NnHybridScorer(ConformerEncoderNet(sn.scorer.num_classes, fn2.shape[-1], **CONFORMER,
                                                device=d_), net.state_dict(), priors, scale=10.0,
                            device=d_) for d_ in (dev, "cpu")]
    e32 = twins[0](fn2)
    nn_f32_err = check_close("conformer float32: card vs cpu", e32.cpu(), twins[1](fn2.cpu()),
                             NN_F32_RTOL, NN_F32_ATOL)
    en2 = sn.scorer(fn2)
    nn_bf16_err = check_close("conformer bf16 vs float32 on the card", en2, e32,
                              NN_BF16_RTOL, NN_BF16_ATOL)
    say(f"conformer on B=2 x 3 s: float32 card vs cpu max abs err {nn_f32_err:.3e} (tolerance "
        f"{NN_F32_ATOL} + {NN_F32_RTOL} x score); bf16 vs float32 {nn_bf16_err:.3e} "
        f"({NN_BF16_ATOL} + {NN_BF16_RTOL} x score)")
    pairs.append(("conformer", sn.decoder, TreeDecoder(
        sn.tree, compile_ngram(sn.lm), sn.beam, device="cpu"), en2, nfn2))
    del twins
    for label, on_dev, on_host, e_, nf_ in pairs:
        on_card = on_dev.decode_scores(e_, nf_)
        on_cpu = on_host.decode_scores(e_.cpu(), nf_.cpu())
        for a, b in zip(on_card, on_cpu):
            if a.words != b.words or abs(a.score - b.score) > DECODE_RTOL * max(1.0, abs(b.score)):
                raise AssertionError(
                    f"cuda vs cpu decode ({label}): {a.words} {a.score} vs {b.words} {b.score}")
        say(f"cuda == cpu decode ({label}) on B=2 x 3 s: {[r.orth[:40] for r in on_card]}")
    # the lattices of a 4 x 3 s batch from a CUDA and a CPU decode
    f4, nf4 = s.frontend(samples[:4, :small], torch.full((4,), small, device=dev))
    e4 = s.scorer(f4)
    h_card = s.decoder.decode_scores_device(e4, nf4)
    h_cpu = s_cpu.decoder.decode_scores_device(e4.cpu(), nf4.cpu())
    n_arcs = 0
    for b in range(4):
        la, lb = (decoder_lattice(h, s.tree.lemmas, b) for h in (h_card, h_cpu))
        if (la.num_nodes, la.node_time.tolist(), sorted(la.final_scores)) != (
                lb.num_nodes, lb.node_time.tolist(), sorted(lb.final_scores)) or [
                (a.from_node, a.to_node, a.lemma) for a in la.arcs] != [
                (a.from_node, a.to_node, a.lemma) for a in lb.arcs]:
            raise AssertionError(f"cuda vs cpu lattice {b}: other nodes or arcs")
        got = torch.tensor([(a.am_score, a.lm_score) for a in la.arcs]
                           + [(la.final_scores[k], 0.0) for k in sorted(la.final_scores)])
        want = torch.tensor([(a.am_score, a.lm_score) for a in lb.arcs]
                            + [(lb.final_scores[k], 0.0) for k in sorted(lb.final_scores)])
        if bool(((got - want).abs() > DECODE_RTOL * want.abs().clamp(min=1.0)).any()):
            raise AssertionError(f"cuda vs cpu lattice {b}: scores off by more than "
                                 f"{DECODE_RTOL} relative")
        n_arcs += len(la.arcs)
    say(f"cuda == cpu lattices on B=4 x 3 s: {n_arcs} arcs, the same nodes and arcs, scores "
        f"within {DECODE_RTOL} relative")

    record = {"kernels": [
        {"name": "gmm_scores", "route": "cuda", "source": "rasr_tpu_torch/csrc/gmm_fused.cu",
         "replaces": "rasr_tpu/ops/pallas/gmm_kernel.py:72",
         "launches": launches["gmm_scores"], "launches_by_path": paths_of("gmm_scores"),
         "max_abs_err": gmm_err,
         "ms": gmm_ms, "plain_ms": gmm_plain_ms, "bound_ms": gmm_bound[0],
         "bound_by": gmm_bound[1], "library_ms": gmm_lib_ms},
        {"name": "mfcc_frames", "route": "cuda", "source": "rasr_tpu_torch/csrc/mfcc_fused.cu",
         "replaces": "rasr_tpu/ops/pallas/frontend_kernel.py:50",
         "launches": launches["mfcc_frames"], "launches_by_path": paths_of("mfcc_frames"),
         "max_abs_err": max(mfcc_err, ext_err),
         "ms": mfcc_ms, "plain_ms": mfcc_plain_ms, "bound_ms": mfcc_bound[0],
         "bound_by": mfcc_bound[1], "library_ms": mfcc_lib_ms},
        {"name": "wordend_block", "route": "cuda",
         "source": "rasr_tpu_torch/csrc/wordend_fused.cu",
         "replaces": "examples/pallas_wordend_microbench.py:81",
         "launches": we_launches["wordend_block"],
         "launches_by_path": paths_of("wordend_block"), "max_abs_err": we_run["max_abs_err"],
         "ms": we_run["ms"], "plain_ms": we_run["plain_ms"], "bound_ms": we_bound[0],
         "bound_by": we_bound[1], "library_ms": None},
        {"name": "row_gather", "route": "cuda", "source": "rasr_tpu_torch/csrc/row_gather.cu",
         "replaces": "examples/pallas_gather_microbench.py:36",
         "launches": ga_launches["row_gather"], "launches_by_path": paths_of("row_gather"),
         "max_abs_err": ga_run["max_abs_err"],
         "ms": ga_run["ms"], "plain_ms": ga_run["plain_ms"], "bound_ms": ga_bound[0],
         "bound_by": ga_bound[1], "library_ms": ga_lib_ms},
    ]}
    print(json.dumps(record))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
        sys.exit(0)
    sys.exit(main())
