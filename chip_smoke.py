#!/usr/bin/env python3
"""Drive the PyTorch port's decode path once on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``rasr_tpu_torch/csrc/``, holds
each against its plain PyTorch version at the main path's shapes, runs
the planted two-word canary, then pushes batches of synthetic 10 s audio
through the full-width benchmark setup (5k words, 2000 x 8 x 45 GMMs,
K=1024): ``FeatureFrontend -> GmmFeatureScorer -> decode_scores_device ->
results_from_device``. Launch counters show that the run went through
both kernels, and a small batch decoded on the card and on the CPU must
agree. Prints per-stage times tagged with the card's name and power
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
# CUDA vs CPU decode of the same scores: identical float ops, so words
# must match exactly; scores within bench.py's cross-backend 1e-2
DECODE_RTOL = 1e-2

BATCH, AUDIO_S, TIMED_BATCHES = 64, 10.0, 2


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device visible\n")
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from rasr_tpu_torch import _build
    from rasr_tpu_torch.device import cuda_device
    from rasr_tpu_torch.host import (
        Allophone, AllophoneState, HmmTopology, Lexicon, MonophoneStateTying,
        NgramLm, TransitionModel, build_default_silence,
    )
    from rasr_tpu_torch.models.lm.ngram import compile_ngram
    from rasr_tpu_torch.ops.frontend import FrontendConfig, frame_signal, num_frames, preemphasize
    from rasr_tpu_torch.ops.kernels.gmm import gmm_scores, gmm_scores_plain
    from rasr_tpu_torch.ops.kernels.mfcc import folded_bases, mfcc_frames, mfcc_frames_plain
    from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu_torch.search.tree import build_prefix_tree
    from rasr_tpu_torch.synthetic import build_setup

    dev = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card_tag()
    name = torch.cuda.get_device_name(0)

    def say(msg):
        print(f"[{tag}] {msg}", flush=True)

    t0 = time.time()
    _build.library()
    say(f"kernel build {time.time() - t0:.2f} s")
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

    # ----------------------------------------------------- planted canary
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
    dec = TreeDecoder(tree, compile_ngram(lm),
                      BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.5), device=dev)
    (res,) = dec.decode_scores(torch.from_numpy(emis).to(dev), np.array([len(seq)]))
    got_words = [lemma.primary_orth for lemma in res.lemmas]
    if got_words != ["[SILENCE]", "AB"] or res.word_ends != [1, 5]:
        raise AssertionError(f"planted canary: {got_words} @ {res.word_ends}")
    say("canary ok: [SILENCE] AB @ [1, 5]")

    # ------------------------------------------- full-width main path
    def main_path():
        t_a = time.time()
        f, nf = s.frontend(samples, lengths)
        torch.cuda.synchronize()
        t_b = time.time()
        e = s.scorer(f)
        torch.cuda.synchronize()
        t_c = time.time()
        results = s.decoder.results_from_device(s.decoder.decode_scores_device(e, nf))
        t_d = time.time()
        return f, e, nf, results, (t_b - t_a, t_c - t_b, t_d - t_c)

    main_path()  # warm-up: cuBLAS handles, allocator, first launches
    gmm_scores.launches = 0
    mfcc_frames.launches = 0
    stage = np.zeros(3)
    for _ in range(TIMED_BATCHES):
        f, e, nf, results, dt = main_path()
        stage += dt
    launches = {"gmm_scores": gmm_scores.launches, "mfcc_frames": mfcc_frames.launches}
    for k, v in launches.items():
        if v < 1:
            raise AssertionError(f"the main path never launched {k}")
    D = s.frontend.output_dim
    if tuple(f.shape) != (BATCH, T, D) or not bool(torch.isfinite(f).all()):
        raise AssertionError(f"features: shape {tuple(f.shape)} or non-finite")
    if tuple(e.shape) != (BATCH, T, st.num_mixtures) or not bool(torch.isfinite(e).all()):
        raise AssertionError(f"emissions: shape {tuple(e.shape)} or non-finite")
    if not bool((nf == T).all()):
        raise AssertionError("frame counts disagree with the audio length")
    if len(results) != BATCH or not all(np.isfinite(r.score) and r.words for r in results):
        raise AssertionError("decode produced an empty or non-finite result")
    audio = TIMED_BATCHES * BATCH * AUDIO_S
    fe_s, sc_s, dec_s = stage / TIMED_BATCHES
    say(f"main path B={BATCH} x {AUDIO_S:g} s ({T} frames), per batch: frontend "
        f"{fe_s * 1e3:.1f} ms, scorer {sc_s * 1e3:.1f} ms, decode {dec_s * 1e3:.1f} ms")
    say(f"throughput {audio / stage.sum():.1f} audio-s/s (K={s.beam.max_hyps}, "
        f"{len(s.tree.lemmas)} lemmas); launches {launches}")
    say(f"sample: {results[0].orth[:80]!r} score {results[0].score:.3f}")

    # ------------------------------------- CUDA decode == CPU decode
    small = int(3.0 * 16000)
    x2 = samples[:2, :small]
    f2, nf2 = s.frontend(x2, torch.full((2,), small, device=dev))
    e2 = s.scorer(f2)
    s_cpu = build_setup(device="cpu")
    f2c, _ = s_cpu.frontend(x2.cpu(), torch.full((2,), small))
    check_close("features cuda vs cpu", f2.cpu(), f2c, 1e-3, 1e-3)
    check_close("emissions cuda vs cpu", e2.cpu(), s_cpu.scorer(f2c), 1e-4, 1e-2)
    on_card = s.decoder.decode_scores(e2, nf2)
    on_cpu = s_cpu.decoder.decode_scores(e2.cpu(), nf2.cpu())
    for a, b in zip(on_card, on_cpu):
        if a.words != b.words or abs(a.score - b.score) > DECODE_RTOL * max(1.0, abs(b.score)):
            raise AssertionError(f"cuda vs cpu decode: {a.words} {a.score} vs {b.words} {b.score}")
    say(f"cuda == cpu decode on B=2 x 3 s: {[r.orth[:40] for r in on_card]}")

    record = {"kernels": [
        {"name": "gmm_scores", "route": "cuda", "source": "rasr_tpu_torch/csrc/gmm_fused.cu",
         "replaces": "rasr_tpu/ops/pallas/gmm_kernel.py:72",
         "launches": launches["gmm_scores"], "max_abs_err": gmm_err,
         "ms": gmm_ms, "plain_ms": gmm_plain_ms},
        {"name": "mfcc_frames", "route": "cuda", "source": "rasr_tpu_torch/csrc/mfcc_fused.cu",
         "replaces": "rasr_tpu/ops/pallas/frontend_kernel.py:50",
         "launches": launches["mfcc_frames"], "max_abs_err": mfcc_err,
         "ms": mfcc_ms, "plain_ms": mfcc_plain_ms},
    ]}
    print(json.dumps(record))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
