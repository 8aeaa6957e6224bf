"""Search-error / WER-parity battery (SURVEY §6, BASELINE configs 4-5).

The port's copy of ``examples/search_error_battery.py``: the same task
(``rasr_tpu_torch.pipeline.battery``, the same seeds), grid and modes,
decoded by the port on ``device`` (the card unless the caller names
another). Run: ``python -m rasr_tpu_torch.examples.search_error_battery``
(``BATTERY_DEVICE=cpu`` decodes on the CPU).

Decodes a synthetic LVCSR task (rasr_tpu.pipeline.battery: 1k-word
prefix-shared lexicon + homophones, 4-gram LM over a Markov source,
GMM emissions under controlled noise) across a (max_hyps, beam) pruning
grid and reports, per operating point:

* WER against the planted truth,
* search-error rate / mean score degradation against a maximally wide
  reference decode,
* the same with bigram lookahead shaping (search/lookahead.py).

The resulting table is recorded in BASELINE.md ("search-error battery")
and the production operating point is pinned as a regression in
tests/test_battery.py.

Env: BATTERY_WORDS / BATTERY_UTTS / BATTERY_NOISE / BATTERY_SEP /
     BATTERY_MODE (grid, power, corr-sweep, scale-sweep, aw-power, lv)
"""

import functools
import json
import os
import sys
import time

import numpy as np

from ..device import resolve
from ..pipeline import battery
from ..pipeline.battery import paired_bootstrap_delta
from ..search.decoder import BeamConfig


def aw_power(device):
    """Across-word battery at statistical power (r3 verdict item 3).

    The history-correction level's flagship claim — "across-word
    production needs bigram shaping" — rests on one 8-utt realization
    (the in-suite pin) and was contradicted by a 32-utt draw of the
    same family. Settle it: N=200 utterances, 2-3 noise dials, paired
    utterance-bootstrap CIs for (bigram - unigram) at the production
    point and one tighter point per dial. Results go to BASELINE.md
    and decide the across-word lookahead-order default.

    Run: BATTERY_MODE=aw-power python -m rasr_tpu_torch.examples.search_error_battery
    (~CPU hours; background job). Env: BATTERY_AW_NOISES="2.8,3.1",
    BATTERY_UTTS=200, BATTERY_WORDS=200, BATTERY_REF_K=1024.
    """
    build_battery_task = functools.partial(battery.build_battery_task, device=device)
    run_operating_point = functools.partial(battery.run_operating_point, device=device)

    words = int(os.environ.get("BATTERY_WORDS", "200"))
    utts = int(os.environ.get("BATTERY_UTTS", "200"))
    noises = [
        float(x)
        for x in os.environ.get("BATTERY_AW_NOISES", "2.8,3.1").split(",")
    ]
    sep = float(os.environ.get("BATTERY_SEP", "1.2"))
    seed = int(os.environ.get("BATTERY_SEED", "1"))
    lm_scale = float(os.environ.get("BATTERY_LM_SCALE", "3.0"))
    ref_k = int(os.environ.get("BATTERY_REF_K", "1024"))
    points = [(256, 90.0), (128, 65.0)]
    print("| noise | K | beam | la | WER | search-err | mean-degr "
          "| dWER(bi-uni) [95% CI] |", flush=True)
    print("|-------|---|------|----|-----|-----------|-----------|---|",
          flush=True)
    for noise in noises:
        t0 = time.time()
        task = build_battery_task(
            num_words=words, num_utts=utts,
            n_train_sentences=int(os.environ.get("BATTERY_TRAIN", "3000")),
            noise=noise, separation=sep,
            lookahead_classes=int(os.environ.get("BATTERY_LA_CLASSES", "250")),
            seed=seed, across_word=True,
        )
        print(f"# noise={noise}: task built in {time.time() - t0:.0f}s "
              f"tree={task.tree.stats()}", file=sys.stderr, flush=True)
        ref_cfg = BeamConfig(
            max_hyps=ref_k, beam=1e9, word_end_limit=128, root_hyps=64,
            lm_scale=lm_scale,
        )
        t0 = time.time()
        ref = run_operating_point(task, ref_cfg)
        print(f"# noise={noise} reference K={ref_k}: wer={ref['wer']:.4f} "
              f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
        for K, beam in points:
            rows = {}
            for bi in (0, 1):
                cfg = BeamConfig(
                    max_hyps=K, beam=beam, word_end_limit=64,
                    root_hyps=16, branch_hyps=64, lm_scale=lm_scale,
                )
                t0 = time.time()
                rows[bi] = run_operating_point(
                    task, cfg, bigram=bool(bi), ref_scores=ref["_scores"]
                )
                print(f"# noise={noise} K={K} beam={beam} bi={bi}: "
                      f"{time.time() - t0:.0f}s", file=sys.stderr, flush=True)
            bs = paired_bootstrap_delta(rows[0], rows[1])
            for bi in (0, 1):
                r = rows[bi]
                d = (
                    f"{bs['delta']:+.4f} [{bs['ci_lo']:+.4f},"
                    f"{bs['ci_hi']:+.4f}] P(bi better)={bs['p_better']:.2f}"
                    if bi else ""
                )
                print(
                    f"| {noise} | {K} | {beam:.0f} "
                    f"| {'bigram' if bi else 'unigram'} | {r['wer']:.4f} "
                    f"| {r['search_error_rate']:.3f} "
                    f"| {r['mean_degradation']:.2f} | {d} |", flush=True,
                )
            for bi in (0, 1):
                bs_ref = paired_bootstrap_delta(ref, rows[bi])
                print(json.dumps({
                    "mode": "aw-power", "noise": noise,
                    "point": f"K{K}_b{beam:.0f}",
                    "la": "bigram" if bi else "unigram",
                    "wer": round(rows[bi]["wer"], 4),
                    "ref_wer": round(ref["wer"], 4),
                    "dwer_vs_ref": round(bs_ref["delta"], 4),
                    "ci": [round(bs_ref["ci_lo"], 4),
                           round(bs_ref["ci_hi"], 4)],
                }), file=sys.stderr, flush=True)


def large_vocab(device):
    """Quality and scale in the SAME experiment (r4 verdict item 1).

    Every prior WER/search-error CI came from <=1k-word tasks while the
    perf work went to 100k words — and the lookahead correction exists
    FOR large vocabularies. This mode builds the battery task at a
    VOCABULARY SWEEP (default 1k/5k/20k), runs the wide reference decode
    ON THE DEVICE (CPU reference decodes at K=2048
    cost 200-400s/utt, which is what capped the old battery at 1k
    words), validates the reference width (K vs 2*K search error), and
    reports the production-point grid with paired-bootstrap CIs for the
    bigram-vs-unigram lookahead delta AT EACH VOCABULARY.

    Run: BATTERY_MODE=lv python -m rasr_tpu_torch.examples.search_error_battery
    Env: BATTERY_LV_WORDS="1000,5000,20000", BATTERY_UTTS=200,
         BATTERY_NOISE/SEP, BATTERY_REF_K=2048 (checked against 2*K).
    """
    build_battery_task = functools.partial(battery.build_battery_task, device=device)
    run_operating_point = functools.partial(battery.run_operating_point, device=device)

    vocabs = [
        int(x)
        for x in os.environ.get("BATTERY_LV_WORDS", "1000,5000,20000").split(",")
    ]
    utts = int(os.environ.get("BATTERY_UTTS", "200"))
    noise = float(os.environ.get("BATTERY_NOISE", "3.0"))
    sep = float(os.environ.get("BATTERY_SEP", "1.3"))
    lm_scale = float(os.environ.get("BATTERY_LM_SCALE", "3.0"))
    ref_k = int(os.environ.get("BATTERY_REF_K", "2048"))
    seed = int(os.environ.get("BATTERY_SEED", "0"))
    points = [
        tuple(int(v) for v in p.split(":"))
        for p in os.environ.get(
            "BATTERY_LV_POINTS", "256:90,512:90,1024:90,1024:120"
        ).split(",")
    ]
    # the reference decodes are EXHAUSTIVE-fan (branch_hyps = K): at
    # K=2048-4096 the dense fan's [B, K * Db] candidates are large, so
    # the batch is split to bound their memory
    ref_batch = int(os.environ.get("BATTERY_REF_BATCH", "50"))

    def prod_cfg(task, K, beam):
        """The PRODUCTION pruning shape (mirrors bench.py defaults):
        root pre-selection, survivors-only emission gather, branch caps
        under the 4096 sort-pad budget with the same dense-vs-compact
        auto rule the bench uses. The lookahead question is asked in
        THIS config — the one production would run."""
        deg = task.tree.arc_ptr[1:] - task.tree.arc_ptr[:-1]
        db = int(max(int((deg[1:] - 2).max()), 1)) if deg.size > 1 else 1
        kb = 146
        budget = max(4096 - 3 * K, 256) - 2
        bw = 0 if kb * db <= budget + 2 else budget
        return BeamConfig(
            max_hyps=K, beam=float(beam), word_end_limit=64,
            root_hyps=16, root_select=min(512, K), deferred_emission=True,
            branch_hyps=kb, branch_width=bw, root_arc_limit=160,
            lm_scale=lm_scale,
        )

    print("| vocab | K | beam | la | WER | search-err | mean-degr "
          "| dWER(bi-uni) [95% CI] |", flush=True)
    print("|-------|---|------|----|-----|-----------|-----------|---|",
          flush=True)
    for V in vocabs:
        t0 = time.time()
        task = build_battery_task(
            num_words=V, num_utts=utts,
            # scale the LM source with the vocabulary so histories keep
            # predicting words (support stays 12 successors/word)
            n_train_sentences=int(
                os.environ.get("BATTERY_TRAIN", "0")
            ) or max(20000, 3 * V),
            noise=noise, separation=sep,
            lookahead_classes=int(os.environ.get("BATTERY_LA_CLASSES", "1200")),
            seed=seed,
        )
        print(f"# vocab={V}: task built in {time.time() - t0:.0f}s "
              f"tree={task.tree.stats()} T={task.emissions.shape[1]}",
              file=sys.stderr, flush=True)
        # ---- reference decode + width validation: the reference is only
        # a reference if doubling K stops changing the best costs
        t0 = time.time()
        ref = run_operating_point(task, BeamConfig(
            max_hyps=ref_k, beam=1e9, word_end_limit=128, root_hyps=64,
            lm_scale=lm_scale,
        ), batch=ref_batch)
        t1 = time.time()
        ref2 = run_operating_point(task, BeamConfig(
            max_hyps=2 * ref_k, beam=1e9, word_end_limit=128, root_hyps=64,
            lm_scale=lm_scale,
        ), ref_scores=ref["_scores"], batch=ref_batch)
        wide_gain = float(np.maximum(ref["_scores"] - ref2["_scores"], 0).mean())
        print(f"# vocab={V} reference K={ref_k}: wer={ref['wer']:.4f} "
              f"({t1 - t0:.0f}s); width check K={2 * ref_k}: "
              f"wer={ref2['wer']:.4f}, mean score gain {wide_gain:.4f} "
              f"({time.time() - t1:.0f}s)", file=sys.stderr, flush=True)
        print(json.dumps({
            "mode": "lv", "vocab": V, "point": "reference", "K": ref_k,
            "wer": round(ref["wer"], 4), "ref2_wer": round(ref2["wer"], 4),
            "width_check_gain": round(wide_gain, 4),
        }), file=sys.stderr, flush=True)
        # the wider decode is the better reference; use its scores
        ref_scores = np.minimum(ref["_scores"], ref2["_scores"])
        for K, beam in points:
            rows = {}
            for bi in (0, 1):
                cfg = prod_cfg(task, K, beam)
                t0 = time.time()
                rows[bi] = run_operating_point(
                    task, cfg, bigram=bool(bi), ref_scores=ref_scores
                )
                print(f"# vocab={V} K={K} beam={beam} bi={bi}: "
                      f"{time.time() - t0:.0f}s", file=sys.stderr, flush=True)
            bs = paired_bootstrap_delta(rows[0], rows[1])
            for bi in (0, 1):
                r = rows[bi]
                d = (
                    f"{bs['delta']:+.4f} [{bs['ci_lo']:+.4f},"
                    f"{bs['ci_hi']:+.4f}] P(bi better)={bs['p_better']:.2f}"
                    if bi else ""
                )
                print(
                    f"| {V} | {K} | {beam} "
                    f"| {'bigram' if bi else 'unigram'} | {r['wer']:.4f} "
                    f"| {r['search_error_rate']:.3f} "
                    f"| {r['mean_degradation']:.2f} | {d} |", flush=True,
                )
                bs_ref = paired_bootstrap_delta(ref, r)
                print(json.dumps({
                    "mode": "lv", "vocab": V, "point": f"K{K}_b{beam}",
                    "la": "bigram" if bi else "unigram",
                    "wer": round(r["wer"], 4),
                    "search_error_rate": round(r["search_error_rate"], 4),
                    "mean_degradation": round(r["mean_degradation"], 3),
                    "dwer_vs_ref": round(bs_ref["delta"], 4),
                    "ci_vs_ref": [round(bs_ref["ci_lo"], 4),
                                  round(bs_ref["ci_hi"], 4)],
                }), file=sys.stderr, flush=True)


def run(device=None):
    """The battery in ``BATTERY_MODE`` on ``device`` (the card when None)."""
    device = resolve(device)
    if os.environ.get("BATTERY_MODE") == "aw-power":
        return aw_power(device)
    if os.environ.get("BATTERY_MODE") == "lv":
        return large_vocab(device)
    build_battery_task = functools.partial(battery.build_battery_task, device=device)
    run_operating_point = functools.partial(battery.run_operating_point, device=device)
    t0 = time.time()
    task = build_battery_task(
        num_words=int(os.environ.get("BATTERY_WORDS", "1000")),
        num_utts=int(os.environ.get("BATTERY_UTTS", "48")),
        n_train_sentences=int(os.environ.get("BATTERY_TRAIN", "12000")),
        noise=float(os.environ.get("BATTERY_NOISE", "3.0")),
        separation=float(os.environ.get("BATTERY_SEP", "1.3")),
        homophone_frac=float(os.environ.get("BATTERY_HOMO", "0.05")),
        lookahead_classes=int(os.environ.get("BATTERY_LA_CLASSES", "1200")),
        seed=int(os.environ.get("BATTERY_SEED", "0")),
    )
    lm_scale = float(os.environ.get("BATTERY_LM_SCALE", "3.0"))
    print(
        f"# task: tree={task.tree.stats()} lm_states={task.tables.num_states} "
        f"utts={task.emissions.shape[0]} T={task.emissions.shape[1]} "
        f"build={time.time() - t0:.0f}s",
        file=sys.stderr,
    )

    ref_cfg = BeamConfig(
        max_hyps=int(os.environ.get("BATTERY_REF_K", "2048")),
        beam=1e9, word_end_limit=128, root_hyps=64, lm_scale=lm_scale,
    )
    t0 = time.time()
    ref = run_operating_point(task, ref_cfg)
    print(
        f"# reference K={ref_cfg.max_hyps}: wer={ref['wer']:.4f} "
        f"({time.time() - t0:.0f}s)",
        file=sys.stderr,
    )
    print(json.dumps({"point": "reference", "K": ref_cfg.max_hyps,
                      "beam": None, "wer": round(ref["wer"], 4)}))

    mode = os.environ.get("BATTERY_MODE", "grid")
    if mode == "power":
        # ---- statistical power upgrade (r2 verdict item 5): the
        # production-relevant points at BATTERY_UTTS=200+, with paired
        # utterance-bootstrap CIs so the "<=0.5% absolute" claims carry
        # intervals instead of word counts.

        points = [(128, 90.0), (256, 90.0), (512, 90.0), (256, 120.0)]
        print("| K | beam | la | WER | search-err | mean-degr | dWER(bi-uni) [95% CI] |")
        print("|---|------|----|-----|-----------|-----------|----------------------|")
        for K, beam in points:
            rows = {}
            for bi in (0, 1):
                cfg = BeamConfig(
                    max_hyps=K, beam=beam, word_end_limit=64,
                    root_hyps=16, lm_scale=lm_scale,
                )
                rows[bi] = run_operating_point(
                    task, cfg, bigram=bool(bi), ref_scores=ref["_scores"]
                )
            bs = paired_bootstrap_delta(rows[0], rows[1])
            for bi in (0, 1):
                r = rows[bi]
                d = (
                    f"{bs['delta']:+.4f} [{bs['ci_lo']:+.4f},{bs['ci_hi']:+.4f}]"
                    f" P(bi better)={bs['p_better']:.2f}" if bi else ""
                )
                print(
                    f"| {K} | {beam:.0f} | {'bigram' if bi else 'unigram'} "
                    f"| {r['wer']:.4f} | {r['search_error_rate']:.3f} "
                    f"| {r['mean_degradation']:.2f} | {d} |", flush=True,
                )
            # ref-parity deltas with CIs (the <=0.5% absolute criterion)
            for bi in (0, 1):
                bs_ref = paired_bootstrap_delta(ref, rows[bi])
                print(json.dumps({
                    "point": f"K{K}_b{beam:.0f}",
                    "la": "bigram" if bi else "unigram",
                    "wer": round(rows[bi]["wer"], 4),
                    "dwer_vs_ref": round(bs_ref["delta"], 4),
                    "ci": [round(bs_ref["ci_lo"], 4), round(bs_ref["ci_hi"], 4)],
                }), file=sys.stderr, flush=True)
        return
    if mode == "corr-sweep":
        # ---- follow-up to scale-sweep: the plain lookahead_scale
        # conflates the (helpful) unigram level with the (over-
        # committing) history correction. Sweep the CORRECTION scale
        # alone at tight beams, and compare order-2 vs order-3 anchors.

        def build_variant(**kw):
            return build_battery_task(
                num_words=int(os.environ.get("BATTERY_WORDS", "1000")),
                num_utts=int(os.environ.get("BATTERY_UTTS", "48")),
                n_train_sentences=int(os.environ.get("BATTERY_TRAIN", "12000")),
                noise=float(os.environ.get("BATTERY_NOISE", "3.0")),
                separation=float(os.environ.get("BATTERY_SEP", "1.3")),
                homophone_frac=float(os.environ.get("BATTERY_HOMO", "0.05")),
                lookahead_classes=int(os.environ.get("BATTERY_LA_CLASSES", "1200")),
                seed=int(os.environ.get("BATTERY_SEED", "0")),
                **kw,
            )

        task3 = task_sm = None
        points = [(64, 60.0), (128, 60.0), (256, 60.0), (256, 90.0)]
        print("| K | beam | la | corr-scale | WER | search-err | mean-degr |")
        print("|---|------|----|-----------|-----|-----------|-----------|")
        for K, beam in points:
            base = None
            for name, bi, csc, tk in (
                ("unigram", 0, 1.0, None),
                ("bigram", 1, 1.0, None),
                ("bigram", 1, 0.5, None),
                ("bigram", 1, 0.25, None),
                ("bigram-smooth", 1, 1.0, "sm"),
                ("trigram", 1, 0.5, 3),
                ("trigram", 1, 1.0, 3),
            ):
                t = task
                if tk == 3:
                    if task3 is None:
                        task3 = build_variant(lookahead_order=3)
                    t = task3
                elif tk == "sm":
                    if task_sm is None:
                        task_sm = build_variant(lookahead_smooth=1.0)
                    t = task_sm
                cfg = BeamConfig(
                    max_hyps=K, beam=beam, word_end_limit=64,
                    root_hyps=16, lm_scale=lm_scale,
                    lookahead_corr_scale=csc,
                )
                r = run_operating_point(
                    t, cfg, bigram=bool(bi), ref_scores=ref["_scores"]
                )
                if base is None:
                    base = r
                    extra = ""
                else:
                    bs = paired_bootstrap_delta(base, r)
                    extra = (
                        f" dWER={bs['delta']:+.4f} "
                        f"[{bs['ci_lo']:+.4f},{bs['ci_hi']:+.4f}] "
                        f"P(better)={bs['p_better']:.2f}"
                    )
                print(
                    f"| {K} | {beam:.0f} | {name} | {csc} | {r['wer']:.4f} "
                    f"| {r['search_error_rate']:.3f} "
                    f"| {r['mean_degradation']:.2f} |{extra}",
                    flush=True,
                )
        return
    if mode == "scale-sweep":
        # ---- lookahead_scale sweep at TIGHT beams (r2 verdict item 3):
        # the reference runs its LM lookahead at reduced scale exactly
        # because the min-potential over-commits tight beams. Columns:
        # unigram and bigram, each at scale in {0.3, 0.5, 0.7, 1.0}.

        points = [(64, 60.0), (128, 60.0), (256, 60.0),
                  (64, 90.0), (128, 90.0), (256, 90.0)]
        scales = [1.0, 0.7, 0.5, 0.3]  # 1.0 first: the unigram@1.0 row
        # is the baseline every bootstrap delta compares against
        print("| K | beam | la | scale | WER | search-err | mean-degr |")
        print("|---|------|----|-------|-----|-----------|-----------|")
        for K, beam in points:
            base = {}
            for bi in (0, 1):
                for sc in scales:
                    cfg = BeamConfig(
                        max_hyps=K, beam=beam, word_end_limit=64,
                        root_hyps=16, lm_scale=lm_scale,
                        lookahead_scale=sc,
                    )
                    t0 = time.time()
                    r = run_operating_point(
                        task, cfg, bigram=bool(bi), ref_scores=ref["_scores"]
                    )
                    la = "bigram" if bi else "unigram"
                    if bi == 0 and sc == 1.0:
                        base = r
                    extra = ""
                    if base and not (bi == 0 and sc == 1.0):
                        bs = paired_bootstrap_delta(base, r)
                        extra = (
                            f" dWER={bs['delta']:+.4f} "
                            f"[{bs['ci_lo']:+.4f},{bs['ci_hi']:+.4f}] "
                            f"P(better)={bs['p_better']:.2f}"
                        )
                    print(
                        f"| {K} | {beam:.0f} | {la} | {sc} | {r['wer']:.4f} "
                        f"| {r['search_error_rate']:.3f} "
                        f"| {r['mean_degradation']:.2f} |{extra}"
                    )
                    print(json.dumps({
                        "point": f"K{K}_b{beam:.0f}_{la}_s{sc}",
                        "wer": round(r["wer"], 4),
                        "search_error_rate": round(r["search_error_rate"], 4),
                        "mean_degradation": round(r["mean_degradation"], 3),
                        "seconds": round(time.time() - t0, 1),
                    }), file=sys.stderr)
        return

    grid = [
        (64, 60.0), (64, 90.0), (64, 120.0),
        (128, 60.0), (128, 90.0), (128, 120.0),
        (256, 60.0), (256, 90.0), (256, 120.0),
        (512, 90.0), (512, 120.0),
    ]
    la_scale = float(os.environ.get("BATTERY_LA_SCALE", "1.0"))
    print(f"| K | beam | la | WER | search-err | mean-degr |")
    print(f"|---|------|----|-----|-----------|-----------|")
    for K, beam in grid:
        for bi in (0, 1):
            cfg = BeamConfig(
                max_hyps=K, beam=beam, word_end_limit=64, root_hyps=16,
                lm_scale=lm_scale,
                lookahead_scale=la_scale if bi else 1.0,
            )
            t0 = time.time()
            r = run_operating_point(
                task, cfg, bigram=bool(bi), ref_scores=ref["_scores"]
            )
            la = "bigram" if bi else "unigram"
            print(
                f"| {K} | {beam:.0f} | {la} | {r['wer']:.4f} "
                f"| {r['search_error_rate']:.3f} | {r['mean_degradation']:.2f} |"
            )
            print(json.dumps({
                "point": f"K{K}_b{beam:.0f}_{la}", "K": K, "beam": beam,
                "lookahead": la, "wer": round(r["wer"], 4),
                "search_error_rate": round(r["search_error_rate"], 4),
                "mean_degradation": round(r["mean_degradation"], 3),
                "seconds": round(time.time() - t0, 1),
            }), file=sys.stderr)


if __name__ == "__main__":
    run("cpu" if os.environ.get("BATTERY_DEVICE") == "cpu" else None)
