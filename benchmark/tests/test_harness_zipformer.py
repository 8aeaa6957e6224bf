"""The Zipformer's cell and the four-card decode cell at a tiny size on the CPU.

``zipformer-train-ce`` passes its check with the configuration's limits
and its fp8 control fails them; the tiny Zipformer scores and decodes
through the decode job's functions; and the data-parallel decode job,
run as two gloo ranks on the CPU, gives the words and scores of the
single-process decode of the same global batches.
"""

import numpy as np
import pytest

from benchmark import run as brun
from benchmark import spec, system, traffic
from benchmark.jobs import decode, decode_dp
from benchmark.tests.tiny import tiny_run


def _line(r):
    out = spec.job(r).run(r)
    return brun.result_line(spec.benchmark(), r, out, "cpu")


# between the port's readings at the tiny size and its fp8 control's, over three
# seeds: loss 3.0e-4 / 2.8e-3, first gradient 0.042 / 0.22, change 0.039 / 0.30
# (a step of 4 x 40 frames averages less rounding away than the cell's 64 x 1,600)
TINY_LIMITS = {"train": {"loss_gap": 1e-3, "grad_norm_gap": 0.1, "update_norm_gap": 0.1}}


def test_zipformer_train_passes_and_its_fp8_control_fails():
    r = tiny_run("zipformer-train-ce", limits=TINY_LIMITS)
    assert spec.model(r.cfg).__name__ == "benchmark.models.zipformer"
    line = _line(r)
    assert line["correct"], line["check"]
    line = _line(tiny_run("zipformer-train-ce", control="fp8", limits=TINY_LIMITS))
    assert not line["correct"], line["check"]


def test_the_tiny_zipformer_decodes_through_the_decode_job():
    r = tiny_run("conformer-decode")
    limits = r.cfg["limits"]
    r.cfg = spec.load_json(spec.HERE / "configs" / "zipformer-l-hybrid.json")
    r.cfg["lexicon"]["num_words"] = 300
    r.cfg["tying"]["num_classes"] = 300
    r.cfg["beam"].update(max_hyps=64, root_select=64, branch_hyps=16, root_hyps=4)
    spec.model(r.cfg).tiny(r.cfg)
    r.cfg["limits"] = {"decode": limits["decode"]}
    out = decode.run(r)
    assert out["failed"] == 0, out["check"]
    assert out["end_to_end"]["audio_s_per_s"] > 0


def _dp_run():
    r = tiny_run("gmm5k-decode-dp4", seconds=8.0)
    r.traffic.update(batch=4, ranks=2, min_s=1.0, max_s=2.0, warmup_s=1.0, sample_per_batch=4,
                     check_utterances=3)
    return r


def test_decode_dp_on_two_gloo_ranks_equals_the_single_process_decode(monkeypatch):
    r = _dp_run()
    seen = {}

    def kept_check(r_, d, weights, kept, longest, results, frames):
        seen.update(results=results, kept=kept)
        return decode.check(r_, d, weights, kept, longest, results, frames)

    monkeypatch.setattr(decode_dp, "check", kept_check)
    out = decode_dp.run(r)
    assert out["failed"] == 0, out["check"]
    results = seen["results"]
    assert len(results) >= 2 and all(len(v) == 4 for v in results.values())
    assert len(seen["kept"]) == 4 * len(results)  # every row, from both ranks
    d = system.draw(r.cfg, r.seed)
    s = system.build(r.cfg, d, "cpu")
    sr = r.cfg["sample_rate"]
    for b, got in results.items():
        x, lengths, _ = traffic.audio_batch(r.traffic, sr, r.seed, b, "cpu")
        feats, nf = s.frontend(x, lengths)
        want = s.decoder.decode_scores(s.scorer(feats, lengths=nf), nf)
        for row, res in got.items():
            assert [lem.primary_orth for lem in res.lemmas] == \
                [lem.primary_orth for lem in want[row].lemmas]
            assert res.word_ends == list(want[row].word_ends)
            assert res.score == pytest.approx(want[row].score, rel=1e-5, abs=1e-3)


def test_decode_dp_reads_its_per_layer_metrics():
    r = _dp_run()
    r.trace = True
    out = decode_dp.run(r)
    got = spec.read_layer_metrics(spec.benchmark(), "gmm5k-decode-dp4", out["layer"])
    assert got["decode_dp.collective_ms_per_batch"]["value"] == 0.0
    # rank 0's card, under the single-card decode's names, for the decode readers
    layer = out["layer"]
    assert spec.reader("mfu.decode")(layer) > 0
    # the CPU has no device events: the idle share reads the whole window idle
    assert spec.reader("device_idle.decode")(layer) == pytest.approx(100.0)
    assert spec.reader("decoder.launches_per_step")(layer) == 0.0
    assert np.isfinite(out["end_to_end"]["setup_s"])


def test_the_counts_equal_the_references_products():
    """``counts/zipformer.py`` against ``FlopCounterMode`` over the plain
    reference at a tiny size, less what the reference computes in its own
    way: ``W_pos`` over every pair of frames (the count takes the 2 T_k - 1
    offsets) and the position scores as a sum of products (no matmul to
    count)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.counts import zipformer as cz
    from benchmark.models import zipformer as mz
    from benchmark.reference import zipformer as rz

    cfg = spec.load_json(spec.HERE / "configs" / "zipformer-l-hybrid.json")
    mz.tiny(cfg)
    C, T = 30, 64
    w = mz.draw_zipformer(cfg, 45, C, 1, "cpu")
    with FlopCounterMode(display=False) as fc:
        rz.logits(torch.randn(T, 45), w, cfg)
    z = cfg["zipformer"]
    pos_macs = 0
    for ds, n, H in zip(z["downsampling_factor"], z["num_encoder_layers"], z["num_heads"]):
        Tk = -(-(T // 2) // ds)
        pos_macs += n * (Tk * Tk * z["pos_dim"] * H * z["pos_head_dim"]  # the reference's W_pos
                         - (2 * Tk - 1) * z["pos_dim"] * H * z["pos_head_dim"]  # the count's
                         - H * Tk * Tk * z["pos_head_dim"])  # the count's position scores
    lo, hi = cz.forward_flop(cfg, 45, C, T)
    assert lo + hi == fc.get_total_flops() - 2 * pos_macs
    m = cz.forward_macs(cfg, 45, C, T)
    assert m["head"] == T * 32 * 32 + T * 32 * C
