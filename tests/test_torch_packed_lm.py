"""PyTorch port vs JAX: the production LM path (``models/lm/packed.py``,
the per-slot half of ``models/lm/ngram.py``, LM images, ``utils/native.py``).

Every case of ``tests/test_packed_lm.py`` runs on both packages on the
same LM, plus: ``compile_packed``'s tables equal to JAX's array for array;
the per-slot ``lookup_prepared`` equal to JAX's on random queries on both
of its routes (replicated probe windows, and one gather per probe with
the window threshold monkeypatched to 0); LM images written by either
package read by the other, a six-entry ``aux`` image (written before
bucketing) included; and a decode from packed tables equal to the decode
from the bucketed ones. Host numpy is the same code, so tables, costs and
next states are held exactly; costs from the host LMs within 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rasr_tpu.models.lm import ngram_tpu as jngram
from rasr_tpu.models.lm import packed as jpacked
from rasr_tpu.models.lm.arpa import NgramLm as JaxNgramLm
from rasr_tpu.utils import native as jnative
from rasr_tpu_torch.models.lm import ngram as tngram
from rasr_tpu_torch.models.lm import packed as tpacked
from rasr_tpu_torch.models.lm.arpa import NgramLm
from rasr_tpu_torch.utils import native as tnative
from rasr_tpu_torch.utils.archive import FileArchive

FIELDS = ("key_state", "key_word", "val_cost", "val_next", "backoff_cost", "backoff_state")
SCALARS = ("order", "max_probe", "start_state", "end_word", "unk_word", "num_states",
           "bucket_bits")
SENTS = [["a", "b", "c"], ["b", "a", "c"], ["a", "c", "b"], ["c", "a"]] * 3


@pytest.fixture(scope="module")
def toy():
    """The reference's toy trigram LM in both packages (same dicts)."""
    return (NgramLm.train_from_text(SENTS, order=3), JaxNgramLm.train_from_text(SENTS, order=3))


def _random_lm(n_words, order, seed):
    rng = np.random.default_rng(seed)
    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2}
    for i in range(n_words):
        vocab[f"w{i}"] = len(vocab)
    ids = list(vocab.values())
    ngrams = {(w,): (float(rng.uniform(1, 9)), float(rng.uniform(0.1, 2))) for w in ids}
    for k in range(2, order + 1):
        prev = [g for g in ngrams if len(g) == k - 1]
        for _ in range(6 * n_words):
            g = prev[int(rng.integers(len(prev)))] + (int(rng.choice(ids)),)
            ngrams[g] = (float(rng.uniform(1, 8)), float(rng.uniform(0.1, 1.5)) if k < order
                         else 0.0)
    return NgramLm(order, vocab, ngrams), JaxNgramLm(order, dict(vocab), dict(ngrams))


def _assert_tables_equal(t, j):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    assert [getattr(t, k) for k in SCALARS] == [getattr(j, k) for k in SCALARS]


def _queries(tables, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, tables.num_states, n).astype(np.int32),
            rng.integers(0, 40, n).astype(np.int32))


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_packed_matches_host_lm(toy, pkg):
    lm = toy[0] if pkg == "torch" else toy[1]
    packed = (tpacked if pkg == "torch" else jpacked).PackedNgramLm.from_ngram_lm(lm)
    rng = np.random.default_rng(0)
    contexts = [()] + [g for g in lm.ngrams if len(g) < lm.order]
    for _ in range(100):
        h = contexts[rng.integers(len(contexts))]
        w = int(rng.choice(list(lm.vocab.values())))
        np.testing.assert_allclose(packed.score(h, w), lm.score(h, w), rtol=1e-5, atol=1e-6)
        assert packed.extended_history(h, w) == lm.extended_history(h, w)


def test_packed_sequence_score(toy):
    got = tpacked.PackedNgramLm.from_ngram_lm(toy[0]).sequence_score(["a", "b", "c"])
    want = jpacked.PackedNgramLm.from_ngram_lm(toy[1]).sequence_score(["a", "b", "c"])
    assert got == want
    np.testing.assert_allclose(got, toy[0].sequence_score(["a", "b", "c"]), rtol=1e-5)


def test_compile_packed_matches_compile_ngram(toy):
    """The packed path's per-slot tables equal JAX's; scoring each context
    (the packed state layout: empty, then per order in sorted order)
    gives the host LM's cost."""
    packed = tpacked.PackedNgramLm.from_ngram_lm(toy[0])
    t_new = tpacked.compile_packed(packed)
    _assert_tables_equal(t_new, jpacked.compile_packed(jpacked.PackedNgramLm.from_ngram_lm(toy[1])))
    assert t_new.bucket_bits == 0 and t_new.order == tngram.compile_ngram(toy[0]).order
    rng = np.random.default_rng(1)
    contexts = [()] + [g for g in toy[0].ngrams if len(g) < toy[0].order]
    for _ in range(60):
        h = contexts[rng.integers(len(contexts))]
        w = int(rng.choice(list(toy[0].vocab.values())))
        sid = 0
        if h:
            row = packed._find(h)
            assert row >= 0
            sid = 1 + sum(packed.ids[k].shape[0] for k in range(len(h) - 1)) + row
        cost, _ = tngram.score_batch(t_new, torch.tensor([sid]), torch.tensor([w]))
        np.testing.assert_allclose(float(cost[0]), toy[0].score(h, w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("order", [2, 3, 4])
def test_compile_packed_tables_equal_jax(order):
    lm, jlm = _random_lm(60, order, seed=order)
    t = tpacked.compile_packed(tpacked.PackedNgramLm.from_ngram_lm(lm))
    _assert_tables_equal(t, jpacked.compile_packed(jpacked.PackedNgramLm.from_ngram_lm(jlm)))


@pytest.mark.parametrize("route", ["replicated", "per-probe"])
@pytest.mark.parametrize("order", [2, 3, 4])
def test_per_slot_lookup_equals_jax(order, route, monkeypatch):
    """Per-slot ``lookup_prepared`` == JAX's on random queries (ids past
    the vocabulary included), on the replicated windows and, with the
    window threshold at 0, one gather per probe."""
    lm, jlm = _random_lm(60, order, seed=10 + order)
    t = tpacked.compile_packed(tpacked.PackedNgramLm.from_ngram_lm(lm))
    j = jpacked.compile_packed(jpacked.PackedNgramLm.from_ngram_lm(jlm))
    if route == "per-probe":
        monkeypatch.setattr(tngram, "REP_WINDOW_BYTES", 0)
    prep = tngram.prepare_lookup(t)
    assert prep.probes == (t.max_probe if route == "per-probe" else 0)
    states, words = _queries(t, 2000, seed=order)
    cost, nxt = tngram.lookup_prepared(t, prep, torch.from_numpy(states), torch.from_numpy(words))
    jcost, jnxt = jngram.lookup_prepared(j, jngram.prepare_lookup(j), jnp.asarray(states),
                                         jnp.asarray(words))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(jcost))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_per_slot_equals_bucketed_scores():
    """The same LM through both layouts: equal costs (bigram: the same
    state ids too)."""
    lm, _ = _random_lm(80, 2, seed=5)
    t = tpacked.compile_packed(tpacked.PackedNgramLm.from_ngram_lm(lm))
    b = tngram.compile_ngram(lm)
    states, words = _queries(b, 3000, seed=2)
    got = tngram.score_batch(t, torch.from_numpy(states), torch.from_numpy(words))
    want = tngram.score_batch(b, torch.from_numpy(states), torch.from_numpy(words))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_native_arpa_parser(tmp_path, toy, pkg):
    native, packed = (tnative, tpacked) if pkg == "torch" else (jnative, jpacked)
    if native.load_native() is None:
        pytest.skip(f"native toolchain unavailable: {getattr(native, 'build_error', '')}")
    arpa = str(tmp_path / "toy.arpa")
    toy[0].write_arpa(arpa)
    lmbin = str(tmp_path / "toy.lmbin")
    assert native.arpa_to_lmbin(arpa, lmbin)
    p = packed.PackedNgramLm.load_lmbin(lmbin)
    assert p.order == toy[0].order
    for seq in (["a", "b"], ["c", "a"], ["a", "b", "c"]):
        np.testing.assert_allclose(p.sequence_score(seq), toy[0].sequence_score(seq), rtol=1e-4)


def test_native_parse_equal_in_both_packages(tmp_path):
    """The port builds the same sources into its own directory: the two
    libraries write the same .lmbin bytes, and the port's parse gives
    JAX's tables."""
    if tnative.load_native() is None or jnative.load_native() is None:
        pytest.skip("native toolchain unavailable")
    assert str(tnative.library_path()).startswith(str(tnative.BUILD_DIR))
    lm, _ = _random_lm(50, 3, seed=7)
    arpa = str(tmp_path / "lm.arpa")
    lm.write_arpa(arpa)
    assert tnative.arpa_to_lmbin(arpa, str(tmp_path / "t.lmbin"))
    assert jnative.arpa_to_lmbin(arpa, str(tmp_path / "j.lmbin"))
    assert (tmp_path / "t.lmbin").read_bytes() == (tmp_path / "j.lmbin").read_bytes()
    _assert_tables_equal(
        tpacked.compile_packed(tpacked.PackedNgramLm.from_arpa(arpa, cache=str(tmp_path / "t2"))),
        jpacked.compile_packed(jpacked.PackedNgramLm.from_arpa(arpa, cache=str(tmp_path / "j2"))))


def test_from_arpa_builds_cache(tmp_path, toy):
    arpa = str(tmp_path / "toy.arpa")
    toy[0].write_arpa(arpa)
    packed = tpacked.PackedNgramLm.from_arpa(arpa)
    np.testing.assert_allclose(
        packed.sequence_score(["a", "b"]), toy[0].sequence_score(["a", "b"]), rtol=1e-4)
    if tnative.load_native() is not None:
        assert os.path.exists(arpa + ".lmbin")


def test_native_rtar_matches_python(tmp_path):
    """The native scan (which ``utils/archive.py`` now reaches through the
    port's binding) gives the Python scan's index."""
    if tnative.load_native() is None:
        pytest.skip("native toolchain unavailable")
    path = str(tmp_path / "a.cache")
    with FileArchive(path, "w") as ar:
        ar.write("x", b"hello" * 200)
        ar.write("y", b"\x01\x02\x03")
        ar.write("x", b"updated")  # shadowing
        ar.write("z", b"gone")
        ar.delete("z")
    index = tnative.rtar_scan(path)
    assert set(index) == {"x", "y"}
    off, flags, raw, comp = index["x"]
    assert tnative.rtar_read(path, off, flags, raw, comp) == b"updated"
    off, flags, raw, comp = index["y"]
    assert tnative.rtar_read(path, off, flags, raw, comp) == b"\x01\x02\x03"
    os.remove(path + ".idx")  # force a scan
    with FileArchive(path, "r") as ar:
        native_index = dict(ar._index)
        ar._index.clear()
        import rasr_tpu_torch.utils.native as mod
        saved, mod._lib, mod._tried = mod._lib, None, True  # the Python scan
        try:
            ar._scan()
        finally:
            mod._lib, mod._tried = saved, False
        assert dict(ar._index) == native_index
        assert ar.read("x") == b"updated"


def test_compile_packed_empty_middle_order(toy):
    """A sparse model with an EMPTY gram order must still compile."""
    packed = tpacked.PackedNgramLm.from_ngram_lm(toy[0])
    packed.ids[1] = np.zeros((0, 2), np.int32)
    packed.cost[1] = np.zeros(0, np.float32)
    packed.backoff[1] = np.zeros(0, np.float32)
    packed._keys[1] = packed._keys[1][:0]
    tables = tpacked.compile_packed(packed)
    words = [toy[0].vocab[w] for w in ("a", "b", "c", "a")]
    costs, _ = tngram.score_batch(tables, torch.zeros(4, dtype=torch.int64), torch.tensor(words))
    for w, c in zip(["a", "b", "c", "a"], costs.numpy()):
        np.testing.assert_allclose(c, toy[0].ngrams[(toy[0].vocab[w],)][0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["bucketed", "per-slot"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_lm_images_cross_packages(tmp_path, layout, writer):
    lm, jlm = _random_lm(40, 3, seed=3)
    if layout == "bucketed":
        t, j = tngram.compile_ngram(lm), jngram.compile_ngram(jlm)
    else:
        t = tpacked.compile_packed(tpacked.PackedNgramLm.from_ngram_lm(lm))
        j = jpacked.compile_packed(jpacked.PackedNgramLm.from_ngram_lm(jlm))
    path = str(tmp_path / "lm.npz")
    if writer == "torch":
        tngram.save_tables(t, path)
        _assert_tables_equal(t, jngram.load_tables(path))
    else:
        jngram.save_tables(j, path)
    back = tngram.load_tables(path)
    _assert_tables_equal(back, j)
    states, words = _queries(t, 500, seed=1)
    for g, w in zip(tngram.score_batch(back, torch.from_numpy(states), torch.from_numpy(words)),
                    tngram.score_batch(t, torch.from_numpy(states), torch.from_numpy(words))):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_six_entry_aux_image_is_per_slot(tmp_path):
    """An image written before bucketing (``aux`` without bucket_bits)
    loads as per-slot tables in both packages, with equal lookups."""
    lm, jlm = _random_lm(40, 2, seed=4)
    j = jpacked.compile_packed(jpacked.PackedNgramLm.from_ngram_lm(jlm))
    path = str(tmp_path / "old.npz")
    arrays = {f: np.asarray(getattr(j, f)) for f in FIELDS}
    np.savez_compressed(path, **arrays, aux=np.array(
        [j.order, j.max_probe, j.start_state, j.end_word, j.unk_word, j.num_states], np.int64))
    t, jj = tngram.load_tables(path), jngram.load_tables(path)
    assert t.bucket_bits == jj.bucket_bits == 0
    _assert_tables_equal(t, jj)
    states, words = _queries(t, 800, seed=9)
    cost, nxt = tngram.score_batch(t, torch.from_numpy(states), torch.from_numpy(words))
    jcost, jnxt = jngram.score_batch(jj, jnp.asarray(states), jnp.asarray(words))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(jcost))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_packed_decode_equals_bucketed_decode(tmp_path):
    """The decoder over packed per-slot tables (from the native parse of
    the LM's ARPA file) gives the words and scores of the decoder over the
    bucketed tables of the same file, exactly."""
    from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu_torch.synthetic import build_setup

    beam = BeamConfig(max_hyps=64, word_end_limit=16, root_hyps=8, branch_hyps=16, lm_scale=10.0)
    s = build_setup(num_words=60, num_phones=10, num_classes=80, densities=2, beam=beam,
                    device="cpu")
    arpa = str(tmp_path / "lm.arpa")
    s.lm.write_arpa(arpa)
    packed = tpacked.compile_packed(tpacked.PackedNgramLm.from_arpa(arpa))
    bucketed = tngram.compile_ngram(NgramLm.read_arpa(arpa))
    assert packed.bucket_bits == 0 and bucketed.bucket_bits == 2
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(3, 16000)) * 0.1).astype(np.float32))
    feats, n = s.frontend(x, torch.tensor([16000, 14000, 12000]))
    e = s.scorer(feats)
    got = TreeDecoder(s.tree, packed, s.beam, device="cpu").decode_scores(e, n)
    want = TreeDecoder(s.tree, bucketed, s.beam, device="cpu").decode_scores(e, n)
    assert [(r.words, r.score) for r in got] == [(r.words, r.score) for r in want]
    assert all(r.words for r in got)
