"""PyTorch port vs JAX: the search-error battery (``pipeline/battery.py``).

At a small size both packages build the same task from the same seed (the
same draws in the same order): lexicon, LM training text and n-grams,
planted references and frame counts, the compiled network and bigram
lookahead, the model; the planted emissions agree to float32 rounding
(1e-5 relative). One operating point decodes to the same words and WER
(scores within 1e-4 relative), and the paired bootstrap gives the same
numbers. The within-word and the across-word (context-grouped) tasks.
"""

import numpy as np
import pytest

from rasr_tpu.pipeline import battery as jbattery
from rasr_tpu.search.decoder import BeamConfig as JaxBeamConfig
from rasr_tpu_torch.pipeline import battery
from rasr_tpu_torch.search.decoder import BeamConfig

SMALL = dict(num_words=60, num_phones=12, num_utts=4, n_train_sentences=300,
             lookahead_classes=8, feat_dim=8)
KINDS = {"within-word": {}, "across-word": dict(across_word=True, context_groups=2)}


@pytest.fixture(scope="module", params=sorted(KINDS))
def tasks(request):
    kw = dict(SMALL, **KINDS[request.param])
    return jbattery.build_battery_task(**kw), battery.build_battery_task(device="cpu", **kw)


def _lexicon_data(lex):
    return [(l.orth, [(p.phonemes, p.score) for p in l.pronunciations], l.special)
            for l in lex.lemmata]


def test_task_arrays_match_jax(tasks):
    want, got = tasks
    assert _lexicon_data(got.lexicon) == _lexicon_data(want.lexicon)
    assert got.train_text == want.train_text
    assert got.refs == want.refs
    assert got.lm.vocab == want.lm.vocab and got.lm.ngrams == want.lm.ngrams
    np.testing.assert_array_equal(got.n_frames, want.n_frames)
    assert got.tying.num_classes == want.tying.num_classes
    np.testing.assert_allclose(got.emissions, want.emissions, rtol=1e-5, atol=1e-4)
    for name in ("emission_class", "arc_ptr", "arc_dst", "arc_cost", "we_word", "we_cost",
                 "we_lemma", "lookahead"):
        np.testing.assert_array_equal(getattr(got.tree, name), getattr(want.tree, name),
                                      err_msg=name)
    for name in ("sub_state", "state_class", "corr"):
        np.testing.assert_array_equal(getattr(got.bigram_la, name),
                                      getattr(want.bigram_la, name), err_msg=name)
    np.testing.assert_array_equal(got.tables.key_word.numpy(), np.asarray(want.tables.key_word))


def test_operating_point_and_bootstrap_match_jax(tasks):
    """A binding beam with and without the bigram lookahead: the same WER,
    error counts and per-utterance errors, scores within 1e-4; the
    search-error rate of one against the other; the paired bootstrap of
    the two operating points."""
    want, got = tasks
    kw = dict(max_hyps=64, beam=60.0, word_end_limit=16, root_hyps=8, lm_scale=2.0)
    rows = {}
    for bigram in (False, True):
        w = jbattery.run_operating_point(want, JaxBeamConfig(**kw), bigram=bigram, batch=2)
        g = battery.run_operating_point(got, BeamConfig(**kw), bigram=bigram, batch=2,
                                        device="cpu")
        assert (g["wer"], g["errors"], g["ref_len"]) == (w["wer"], w["errors"], w["ref_len"])
        np.testing.assert_array_equal(g["_utt_errors"], w["_utt_errors"])
        np.testing.assert_array_equal(g["_utt_ref_len"], w["_utt_ref_len"])
        np.testing.assert_allclose(g["_scores"], w["_scores"], rtol=1e-4)
        rows[bigram] = g, w
    # the search-error yardstick: the lookahead decode against the plain one
    w = jbattery.run_operating_point(want, JaxBeamConfig(**kw), bigram=True, batch=2,
                                     ref_scores=rows[False][1]["_scores"])
    g = battery.run_operating_point(got, BeamConfig(**kw), bigram=True, batch=2,
                                    ref_scores=rows[False][0]["_scores"], device="cpu")
    assert g["search_error_rate"] == w["search_error_rate"]
    np.testing.assert_allclose(g["mean_degradation"], w["mean_degradation"], rtol=1e-3,
                               atol=1e-3)
    got_d = battery.paired_bootstrap_delta(rows[False][0], rows[True][0], n_boot=500)
    want_d = jbattery.paired_bootstrap_delta(rows[False][1], rows[True][1], n_boot=500)
    assert got_d == want_d


def test_grouped_context_tying_matches_jax():
    """The context-grouped tying draws its groups as the reference does
    and interns the same classes in the same order."""
    from rasr_tpu.models.allophone import Allophone as JaxAllophone
    from rasr_tpu.models.allophone import AllophoneState as JaxAllophoneState
    from rasr_tpu_torch.models.allophone import Allophone, AllophoneState

    want = jbattery.GroupedContextTying(np.random.default_rng(4), 9, groups=3)
    got = battery.GroupedContextTying(np.random.default_rng(4), 9, groups=3)
    assert (got.lgroup, got.rgroup) == (want.lgroup, want.rgroup)
    rng = np.random.default_rng(5)
    for c, left, right, st in rng.integers(0, 10, size=(40, 4)):
        args = dict(left=int(left), right=int(right))
        assert got.classify(AllophoneState(Allophone(int(c), **args), int(st) % 3)) == \
            want.classify(JaxAllophoneState(JaxAllophone(int(c), **args), int(st) % 3))
    assert got.num_classes == want.num_classes


def test_rnn_fusion_battery_example_runs(monkeypatch):
    """The ported example at a small size on the CPU: the 2-gram, 4-gram
    and fused rows, each fused row with its bootstrap against the 2-gram."""
    from rasr_tpu_torch.examples import rnn_fusion_battery

    for k, v in dict(RNNB_WORDS="40", RNNB_UTTS="4", RNNB_TRAIN="200", RNNB_EPOCHS="2",
                     RNNB_WEIGHTS="0.5,1.0").items():
        monkeypatch.setenv(k, v)
    rows = rnn_fusion_battery.run("cpu")
    assert [(name, w) for name, w, _, _ in rows] == [
        ("ngram-2", 0.0), ("ngram-4", 0.0), ("2gram+rnn", 0.5), ("2gram+rnn", 1.0)]
    assert all(0.0 <= r["wer"] <= 1.0 for _, _, r, _ in rows)
    assert rows[0][3] is None and all(bs is not None for *_, bs in rows[1:])


def test_rnn_streaming_long_example_runs():
    """The ported example at 120 frames in blocks of 40: the pool keeps
    2K + R x Tb rows after every feed, the 80-frame prefix streams as it
    decodes offline."""
    from rasr_tpu_torch.examples import rnn_streaming_long

    out = rnn_streaming_long.run("cpu", T=120, Tb=40, Tp=80)
    assert out["pool_rows"] == [2 * 96 + 16 * 40]
    assert out["result"].score < 1e29


def test_search_error_battery_example_runs(monkeypatch, capsys):
    """The ported example's power mode at a small size on the CPU: one
    table row per operating point and lookahead."""
    from rasr_tpu_torch.examples import search_error_battery

    for k, v in dict(BATTERY_MODE="power", BATTERY_WORDS="30", BATTERY_UTTS="2",
                     BATTERY_TRAIN="150", BATTERY_LA_CLASSES="8", BATTERY_REF_K="128").items():
        monkeypatch.setenv(k, v)
    search_error_battery.run("cpu")
    rows = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("| ") and line[2].isdigit()]
    assert len(rows) == 8
