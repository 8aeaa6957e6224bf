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
- the planted two-word canary under both of bench.py's canary configs;
- the main path: batches of synthetic 10 s audio through the full-width
  benchmark setup (5k words, 2000 x 8 x 45 GMMs, K=1024) under bench.py's
  production beam (root select 512, deferred emission, root-arc cap 160),
  ``FeatureFrontend -> GmmFeatureScorer -> decode_scores_device ->
  results_from_device``;
- the same setup under decoder slice A's beam, at reduced depth.

A small batch decoded on the card and on the CPU must agree under both
beams. Prints per-stage times tagged with the card's name and power
limit, one JSON line of kernel records, and as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It needs a CUDA card and the
repository beside it.
"""

import json
import os
import subprocess
import sys
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

BATCH, AUDIO_S, TIMED_BATCHES = 64, 10.0, 2
SLICE_A_BATCH = 16  # slice A at reduced depth: one timed batch


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device visible\n")
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from rasr_tpu_torch import _build
    from rasr_tpu_torch.device import cuda_device, cuda_ms
    from rasr_tpu_torch.examples import gather_microbench, wordend_microbench
    from rasr_tpu_torch.host import (
        Allophone, AllophoneState, HmmTopology, Lexicon, MonophoneStateTying,
        NgramLm, TransitionModel, build_default_silence,
    )
    from rasr_tpu_torch.models.lm.ngram import compile_ngram
    from rasr_tpu_torch.ops.frontend import FrontendConfig, frame_signal, num_frames, preemphasize
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores, gmm_scores_plain
    from rasr_tpu_torch.ops.kernels.mfcc import folded_bases, mfcc_frames, mfcc_frames_plain
    from rasr_tpu_torch.ops.kernels.row_gather import row_gather, row_gather_plain
    from rasr_tpu_torch.ops.kernels.wordend import WORD_NONE, wordend_block, wordend_block_plain
    from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu_torch.search.tree import build_prefix_tree
    from rasr_tpu_torch.synthetic import SLICE_A_BEAM, build_setup

    dev = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card_tag()
    name = torch.cuda.get_device_name(0)
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
    for line in _build.build_log.splitlines():
        if "registers" in line:  # ptxas: per-kernel registers / shared memory
            sys.stderr.write(line.strip() + "\n")

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
    gmm_err = 0.0
    for max_approx in (True, False):
        before = gmm_scores.launches
        got = gmm_scores(feats[:4096], st, max_approx)
        torch.cuda.synchronize()
        if gmm_scores.launches <= before:
            raise AssertionError("gmm_scores did not launch its kernel")
        ref = gmm_scores_plain(feats[:4096], st, max_approx)
        gmm_err = max(gmm_err, check_close(f"gmm max_approx={max_approx}", got, ref,
                                           GMM_RTOL, GMM_ATOL))
    gmm_ms = cuda_ms(lambda: gmm_scores(feats, st, True), 5)
    gmm_plain_ms = cuda_ms(lambda: gmm_scores_plain(feats, st, True), 5)
    say(f"gmm_scores N={N} M={st.num_mixtures} K={st.max_densities} D={st.dim}: "
        f"kernel {gmm_ms:.3f} ms, plain {gmm_plain_ms:.3f} ms, max abs err {gmm_err:.3e}")
    del feats

    # ------------------------------------------------ kernel phase: MFCC
    p = s.frontend.params
    cosw, sinw = folded_bases(p)
    frames = frame_signal(preemphasize(samples, cfg.preemphasis), T, cfg)
    before = mfcc_frames.launches
    got = mfcc_frames(frames, cosw, sinw, p.mel, p.dct, cfg.log_floor)
    torch.cuda.synchronize()
    if mfcc_frames.launches <= before:
        raise AssertionError("mfcc_frames did not launch its kernel")
    ref = mfcc_frames_plain(frames, cosw, sinw, p.mel, p.dct, cfg.log_floor)
    mfcc_err = check_close("mfcc", got, ref, MFCC_RTOL, MFCC_ATOL)
    mfcc_ms = cuda_ms(lambda: mfcc_frames(frames, cosw, sinw, p.mel, p.dct, cfg.log_floor), 10)
    mfcc_plain_ms = cuda_ms(
        lambda: mfcc_frames_plain(frames, cosw, sinw, p.mel, p.dct, cfg.log_floor), 10
    )
    say(f"mfcc_frames N={N} L={cfg.frame_length}: kernel {mfcc_ms:.3f} ms, "
        f"plain {mfcc_plain_ms:.3f} ms, max abs err {mfcc_err:.3e}")
    del frames, got, ref

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
    say(f"wordend_block {wordend_microbench.SHAPE}: device time kernel {we_run['ms']:.4f} ms, "
        f"plain {we_run['plain_ms']:.4f} ms; per eager call {we_run['eager_ms']:.4f} ms, "
        f"plain {we_run['plain_eager_ms']:.4f} ms; launches {we_launches}")
    say(f"row_gather {gather_microbench.SHAPE}: device time kernel {ga_run['ms']:.4f} ms "
        f"({ga_run['ns_per_row']:.3f} ns/row), plain {ga_run['plain_ms']:.4f} ms; per eager "
        f"call {ga_run['eager_ms']:.4f} ms, plain {ga_run['plain_eager_ms']:.4f} ms; "
        f"launches {ga_launches}")

    # ------------------------- planted canary under both bench.py configs
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    lm = NgramLm.train_from_text([["AB", "BA"], ["BA", "AB"]], order=2)
    tree = build_prefix_tree(lex, tying, topo, TransitionModel(), lm_vocab=lm.vocab)

    def cls_of(sym):
        return tying.classify(AllophoneState(Allophone(lex.phonemes[sym].id), 0))

    seq = [cls_of("si")] * 2 + [cls_of("a")] * 2 + [cls_of("b")] * 2
    emis = np.full((1, len(seq), tying.num_classes), 50.0, np.float32)
    for t, c in enumerate(seq):
        emis[0, t, c] = 0.0
    for canary_beam in (  # bench.py:332-337
        BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.5),
        BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.5, root_hyps=4, root_select=8,
                   root_arc_limit=2, branch_hyps=16, deferred_emission=True),
    ):
        dec = TreeDecoder(tree, compile_ngram(lm), canary_beam, device=dev)
        (res,) = dec.decode_scores(torch.from_numpy(emis).to(dev), np.array([len(seq)]))
        got_words = [lemma.primary_orth for lemma in res.lemmas]
        if got_words != ["[SILENCE]", "AB"] or res.word_ends != [1, 5]:
            raise AssertionError(f"planted canary ({canary_beam}): {got_words} @ {res.word_ends}")
    say("canary ok: [SILENCE] AB @ [1, 5] (plain + rsel/defer/caps)")

    # ------------------------------------------------------ decode paths
    def run_batch(decoder, x, n):
        t_a = time.time()
        f, nf = s.frontend(x, n)
        torch.cuda.synchronize()
        t_b = time.time()
        e = s.scorer(f)
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
    peak = torch.cuda.max_memory_allocated(dev)
    check_outputs(f, e, nf, results, BATCH)
    report("main path (production beam)", stage, TIMED_BATCHES, BATCH, launches, peak)
    say(f"sample: {results[0].orth[:80]!r} score {results[0].score:.3f}")
    del f, e, results

    # slice A: the same setup without the slice-B pruning, reduced depth
    dec_a = TreeDecoder(s.tree, compile_ngram(s.lm), SLICE_A_BEAM, device=dev)
    xa, na = samples[:SLICE_A_BATCH], lengths[:SLICE_A_BATCH]
    run_batch(dec_a, xa[:, :16000], torch.full_like(na, 16000))  # warm-up on 1 s, as the main path's
    reset_counts()
    f, e, nf, results, stage = run_batch(dec_a, xa, na)
    launches_a = read_counts("slice A path", gmm_scores, mfcc_frames)
    check_outputs(f, e, nf, results, SLICE_A_BATCH)
    report("slice A", stage, 1, SLICE_A_BATCH, launches_a)
    del f, e, results

    # ------------------------- CUDA decode == CPU decode, both beams
    small = int(3.0 * 16000)
    x2 = samples[:2, :small]
    f2, nf2 = s.frontend(x2, torch.full((2,), small, device=dev))
    e2 = s.scorer(f2)
    s_cpu = build_setup(device="cpu")
    f2c, _ = s_cpu.frontend(x2.cpu(), torch.full((2,), small))
    check_close("features cuda vs cpu", f2.cpu(), f2c, 1e-3, 1e-3)
    check_close("emissions cuda vs cpu", e2.cpu(), s_cpu.scorer(f2c), 1e-4, 1e-2)
    dec_a_cpu = TreeDecoder(s_cpu.tree, compile_ngram(s_cpu.lm), SLICE_A_BEAM)
    for label, on_dev, on_host in (("production", s.decoder, s_cpu.decoder),
                                   ("slice A", dec_a, dec_a_cpu)):
        on_card = on_dev.decode_scores(e2, nf2)
        on_cpu = on_host.decode_scores(e2.cpu(), nf2.cpu())
        for a, b in zip(on_card, on_cpu):
            if a.words != b.words or abs(a.score - b.score) > DECODE_RTOL * max(1.0, abs(b.score)):
                raise AssertionError(
                    f"cuda vs cpu decode ({label}): {a.words} {a.score} vs {b.words} {b.score}")
        say(f"cuda == cpu decode ({label} beam) on B=2 x 3 s: {[r.orth[:40] for r in on_card]}")

    record = {"kernels": [
        {"name": "gmm_scores", "route": "cuda", "source": "rasr_tpu_torch/csrc/gmm_fused.cu",
         "replaces": "rasr_tpu/ops/pallas/gmm_kernel.py:72",
         "launches": launches["gmm_scores"], "max_abs_err": gmm_err,
         "ms": gmm_ms, "plain_ms": gmm_plain_ms},
        {"name": "mfcc_frames", "route": "cuda", "source": "rasr_tpu_torch/csrc/mfcc_fused.cu",
         "replaces": "rasr_tpu/ops/pallas/frontend_kernel.py:50",
         "launches": launches["mfcc_frames"], "max_abs_err": mfcc_err,
         "ms": mfcc_ms, "plain_ms": mfcc_plain_ms},
        {"name": "wordend_block", "route": "cuda",
         "source": "rasr_tpu_torch/csrc/wordend_fused.cu",
         "replaces": "examples/pallas_wordend_microbench.py:81",
         "launches": we_launches["wordend_block"], "max_abs_err": we_run["max_abs_err"],
         "ms": we_run["ms"], "plain_ms": we_run["plain_ms"]},
        {"name": "row_gather", "route": "cuda", "source": "rasr_tpu_torch/csrc/row_gather.cu",
         "replaces": "examples/pallas_gather_microbench.py:36",
         "launches": ga_launches["row_gather"], "max_abs_err": ga_run["max_abs_err"],
         "ms": ga_run["ms"], "plain_ms": ga_run["plain_ms"]},
    ]}
    print(json.dumps(record))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
