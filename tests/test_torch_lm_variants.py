"""PyTorch port vs JAX: the class LM and the log-linear LM combination
(``models/lm/classlm.py``).

The class-LM and ``CombineLm`` cases of ``tests/test_lm_variants.py`` run
on both packages over the same toy class LM and compare what comes back:
host scores exactly (the same float64 host code), ``compile_to_device``'s
bucketed tables array for array, and the port's table lookups against the
host scores within the reference's 1e-5. A larger random class LM is
compiled by both and decoded on the port from its tables.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rasr_tpu.models.lm.arpa as jarpa
import rasr_tpu.models.lm.classlm as jclass
import rasr_tpu.models.lm.interface as jiface
import rasr_tpu.models.lm.ngram_tpu as jngram
import rasr_tpu_torch.models.lm.arpa as tarpa
import rasr_tpu_torch.models.lm.classlm as tclass
import rasr_tpu_torch.models.lm.interface as tiface
import rasr_tpu_torch.models.lm.ngram as tngram

PKGS = {"torch": (tarpa, tclass, tiface), "jax": (jarpa, jclass, jiface)}
FIELDS = ("key_state", "key_word", "val_cost", "val_next", "backoff_cost", "backoff_state")


def _toy_class_lm(pkg):
    """The reference's toy: DIGIT={one,two}, VERB={call}; specials map to themselves."""
    arpa, classlm, _ = PKGS[pkg]
    cls_vocab = {"<s>": 0, "</s>": 1, "<unk>": 2, "DIGIT": 3, "VERB": 4}
    ngrams = {(0,): (99.0, 0.1), (1,): (1.0, 0.0), (2,): (5.0, 0.0), (3,): (0.7, 0.2),
              (4,): (1.2, 0.3), (4, 3): (0.3, 0.0)}
    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2, "one": 3, "two": 4, "call": 5}
    w2c = {"one": "DIGIT", "two": "DIGIT", "call": "VERB",
           "<s>": "<s>", "</s>": "</s>", "<unk>": "<unk>"}
    return classlm.ClassLm(arpa.NgramLm(2, cls_vocab, ngrams), vocab, w2c)


def _random_class_lm(pkg, seed=0, words=120, classes=12):
    arpa, classlm, _ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2}
    for i in range(words):
        vocab[f"w{i}"] = len(vocab)
    w2c = {w: f"C{int(rng.integers(classes))}" for w in vocab if not w.startswith("<")}
    sents = [[w2c[f"w{int(i)}"] for i in rng.integers(0, words, size=int(rng.integers(2, 9)))]
             for _ in range(200)]
    sents.append([f"C{c}" for c in range(classes)] + ["<unk>"])
    return classlm.ClassLm(arpa.NgramLm.train_from_text(sents, order=2), vocab, w2c)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_class_lm_scores(pkg):
    lm = _toy_class_lm(pkg)
    h = lm.start_history()
    one, call = lm.vocab["one"], lm.vocab["call"]
    np.testing.assert_allclose(lm.score(h, one), 0.1 + 0.7 + np.log(2), rtol=1e-6)
    np.testing.assert_allclose(lm.score(h, call), 0.1 + 1.2, rtol=1e-6)
    h2 = lm.extended_history(h, call)
    np.testing.assert_allclose(lm.score(h2, one), 0.3 + np.log(2), rtol=1e-6)
    manual = lm.score(h, call) + lm.score(h2, one) + lm.sentence_end_score(
        lm.extended_history(h2, one))
    np.testing.assert_allclose(lm.sequence_score(["call", "one"]), manual, rtol=1e-6)


def test_class_lm_scores_equal_across_packages():
    t, j = _random_class_lm("torch"), _random_class_lm("jax")
    rng = np.random.default_rng(1)
    for _ in range(40):
        seq = [f"w{int(i)}" for i in rng.integers(0, 120, size=5)]
        assert t.sequence_score(seq) == j.sequence_score(seq)


@pytest.mark.parametrize("build", [_toy_class_lm, _random_class_lm])
def test_class_lm_device_tables_match_host(build):
    """``compile_to_device`` gives JAX's tables; walking a sentence
    through the port's lookup gives the host scores."""
    lm = build("torch")
    tables = lm.compile_to_device()
    jt = build("jax").compile_to_device()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tables, f).numpy(), np.asarray(getattr(jt, f)))
    assert (tables.start_state, tables.bucket_bits) == (jt.start_state, jt.bucket_bits)
    words = [w for w in lm.vocab if not w.startswith("<")][:12]
    h, state = lm.start_history(), tables.start_state
    for tok in words:
        w = lm.vocab[tok]
        cost, nxt = tngram.score_batch(tables, torch.tensor([state]), torch.tensor([w]))
        jcost, jnxt = jngram.score_batch(jt, jnp.asarray([state], jnp.int32),
                                         jnp.asarray([w], jnp.int32))
        np.testing.assert_allclose(float(cost[0]), lm.score(h, w), rtol=1e-5)
        assert float(cost[0]) == float(jcost[0]) and int(nxt[0]) == int(jnxt[0])
        h = lm.extended_history(h, w)
        state = int(nxt[0])


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_combine_lm_weighted_sum(pkg):
    _, classlm, iface = PKGS[pkg]
    lm = _toy_class_lm(pkg)
    zg = iface.Zerogram(dict(lm.vocab))
    comb = classlm.CombineLm([lm, zg], [0.7, 0.3])
    h = comb.start_history()
    one = comb.vocab["one"]
    expect = 0.7 * lm.score(lm.start_history(), one) + 0.3 * zg.score((), one)
    np.testing.assert_allclose(comb.score(h, one), expect, rtol=1e-6)
    h2 = comb.extended_history(h, comb.vocab["call"])
    expect2 = (0.7 * lm.score(lm.extended_history(lm.start_history(), comb.vocab["call"]), one)
               + 0.3 * zg.score((), one))
    np.testing.assert_allclose(comb.score(h2, one), expect2, rtol=1e-6)


def test_combine_lm_equal_across_packages():
    got, want = [], []
    for pkg, out in (("torch", got), ("jax", want)):
        _, classlm, iface = PKGS[pkg]
        lm = _random_class_lm(pkg, seed=2)
        comb = classlm.CombineLm([lm, iface.Zerogram(dict(lm.vocab))], [0.6, 0.4])
        out.append(comb.sequence_score(["w3", "w7", "w11", "w3"]))
        with pytest.raises(ValueError):
            classlm.CombineLm([lm], [0.5, 0.5])
    assert got == want


def test_class_lm_decodes_from_its_tables():
    """The decoder runs a class LM's tables over a network whose word ids
    are the class LM's vocabulary, as it runs a word n-gram's."""
    from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu_torch.synthetic import build_setup

    beam = BeamConfig(max_hyps=64, word_end_limit=16, root_hyps=8, branch_hyps=16, lm_scale=5.0)
    s = build_setup(num_words=60, num_phones=10, num_classes=80, densities=2, beam=beam,
                    device="cpu")
    rng = np.random.default_rng(3)
    words = [w for w in s.lm.vocab if not w.startswith("<")]
    w2c = {w: f"C{int(rng.integers(6))}" for w in words}
    sents = [[w2c[w] for w in rng.choice(words, size=5)] for _ in range(100)]
    sents.append([f"C{c}" for c in range(6)] + ["<unk>"])
    lm = tclass.ClassLm(tarpa.NgramLm.train_from_text(sents, order=2), s.lm.vocab, w2c)
    x = torch.from_numpy((rng.normal(size=(2, 16000)) * 0.1).astype(np.float32))
    feats, n = s.frontend(x, torch.tensor([16000, 12000]))
    res = TreeDecoder(s.tree, lm.compile_to_device(), s.beam, device="cpu").decode_scores(
        s.scorer(feats), n)
    assert all(r.words and np.isfinite(r.score) for r in res), res
