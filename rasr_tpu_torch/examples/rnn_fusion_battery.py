"""RNN-fusion quality under truncated-history recombination.

The port's copy of ``examples/rnn_fusion_battery.py``: the search-error
battery's task (``pipeline/battery.py``: a Markov source -> planted GMM
emissions, so histories predict words) decoded with an order-2 n-gram
for recombination (two hypotheses merge on one word of history) and an
LSTM LM trained on the same text fused at a sweep of weights. Reported
per weight: WER and the paired-bootstrap delta against the pure 2-gram
decode, beside reference rows for the pure 2-gram and 4-gram. The RNN
should recover part of the 4-gram's advantage while recombining on
2-gram states.

Run: ``python -m rasr_tpu_torch.examples.rnn_fusion_battery`` (on the card;
``RNNB_DEVICE=cpu`` runs it on the CPU).
Env: RNNB_WORDS/RNNB_UTTS/RNNB_TRAIN/RNNB_NOISE/RNNB_MARKOV/RNNB_SUPPORT/
RNNB_HOMO/RNNB_SEED/RNNB_LM_SCALE/RNNB_EMBED/RNNB_HIDDEN/RNNB_EPOCHS/
RNNB_WEIGHTS (the reference's knobs).
"""

import json
import os
import sys
import time

import numpy as np

from ..device import resolve
from ..lattice.evaluator import EditStats, align_tokens
from ..models.lm.arpa import NgramLm
from ..models.lm.ngram import compile_ngram
from ..models.lm.rnn import RnnLm
from ..pipeline.battery import build_battery_task, paired_bootstrap_delta
from ..search.decoder import BeamConfig, TreeDecoder
from ..search.rnn_fusion import build_rnn_fusion


def decode_wer(task, tables, cfg, device, rnn_fusion=None):
    dec = TreeDecoder(task.tree, tables, cfg, rnn_fusion=rnn_fusion, device=device)
    results = dec.decode_scores(task.emissions, task.n_frames)
    stats = EditStats()
    B = task.emissions.shape[0]
    errs = np.zeros(B, np.int64)
    ref = np.zeros(B, np.int64)
    for b, res in enumerate(results):
        st, _ = align_tokens(task.refs[b], res.words)
        stats.add(st)
        errs[b], ref[b] = st.errors, st.reference_length
    return {"wer": stats.wer, "_utt_errors": errs, "_utt_ref_len": ref}


def run(device=None) -> list:
    """The battery on ``device`` (the card when None); returns its rows
    ``(lm, rnn weight, result, bootstrap vs the 2-gram)``."""
    device = resolve(device)
    t0 = time.time()
    task = build_battery_task(
        num_words=int(os.environ.get("RNNB_WORDS", "300")),
        num_utts=int(os.environ.get("RNNB_UTTS", "48")),
        n_train_sentences=int(os.environ.get("RNNB_TRAIN", "6000")),
        noise=float(os.environ.get("RNNB_NOISE", "2.8")),
        separation=1.3,
        lm_order=4,
        # a second-order Markov source: a bigram LM captures the
        # first-order default source exactly, leaving fusion no headroom
        markov_order=int(os.environ.get("RNNB_MARKOV", "2")),
        markov_support=int(os.environ.get("RNNB_SUPPORT", "12")),
        homophone_frac=float(os.environ.get("RNNB_HOMO", "0.05")),
        seed=int(os.environ.get("RNNB_SEED", "0")),
        device=device,
    )
    lm_scale = float(os.environ.get("RNNB_LM_SCALE", "3.0"))
    print(f"# task built ({time.time() - t0:.0f}s)", file=sys.stderr)

    # order-2 recombination LM over the same text (real truncation)
    lm2 = NgramLm.train_from_text(task.train_text, order=2)
    tab2 = compile_ngram(lm2)
    assert lm2.vocab == task.lm.vocab  # the tree's word ids

    t0 = time.time()
    rnn = RnnLm.train_from_text(
        task.train_text,
        embed_dim=int(os.environ.get("RNNB_EMBED", "32")),
        hidden_dim=int(os.environ.get("RNNB_HIDDEN", "64")),
        epochs=int(os.environ.get("RNNB_EPOCHS", "6")),
        device=device,
    )
    print(f"# rnn trained ({time.time() - t0:.0f}s)", file=sys.stderr)

    cfg = BeamConfig(max_hyps=256, beam=90.0, word_end_limit=64, root_hyps=16,
                     lm_scale=lm_scale)
    rows = []
    base2 = decode_wer(task, tab2, cfg, device)
    rows.append(("ngram-2", 0.0, base2, None))
    base4 = decode_wer(task, task.tables, cfg, device)
    rows.append(("ngram-4", 0.0, base4, paired_bootstrap_delta(base2, base4)))
    weights = [float(x) for x in os.environ.get("RNNB_WEIGHTS", "0.3,0.5,0.7,1.0").split(",")]
    for w in weights:
        fusion = build_rnn_fusion(rnn, lm2.vocab, weight=w * lm_scale, device=device)
        r = decode_wer(task, tab2, cfg, device, rnn_fusion=fusion)
        rows.append(("2gram+rnn", w, r, paired_bootstrap_delta(base2, r)))

    print("| lm | rnn-scale (x lm-scale) | WER | dWER vs 2gram [95% CI] |")
    print("|----|------------------------|-----|------------------------|")
    for name, w, r, bs in rows:
        d = (
            f"{bs['delta']:+.4f} [{bs['ci_lo']:+.4f},{bs['ci_hi']:+.4f}] "
            f"P(better)={bs['p_better']:.2f}" if bs else "-"
        )
        print(f"| {name} | {w} | {r['wer']:.4f} | {d} |")
        print(json.dumps({"lm": name, "rnn_scale": w, "wer": round(r["wer"], 4)}),
              file=sys.stderr)
    return rows


if __name__ == "__main__":
    run("cpu" if os.environ.get("RNNB_DEVICE") == "cpu" else None)
