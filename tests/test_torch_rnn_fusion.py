"""PyTorch port vs JAX: first-pass RNN-LM fusion (``search/rnn_fusion.py``
and the decoder's state pool).

Every case of ``tests/test_rnn_fusion.py`` as port == JAX: the fusion
tables, the cell step and word scores; pruning off, the fused decode
equals the brute force over word sequences (scored by alignment +
lm_scale * ngram + weight * rnn) and the JAX decoder; fusion changes the
answer; streamed blocks with the pool compaction equal the offline decode
and keep the pool at 2K + R x Tb rows; fusion composes with the bigram
lookahead. Beam partitioning: tests/test_torch_parallel_decode.py. A production-beam
case (root select, deferred emission, compact branch slots, binding K, R,
H and Kb) holds every frame's records and the final beams to the JAX
decoder's on the decoder tests' tie-free system. Tolerances: float32 math
1e-5; decodes: words, word ends and record ids exact, scores rtol 1e-4.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.models.lm.rnn import RnnLm as JaxRnnLm
from rasr_tpu.search import decoder as jdec
from rasr_tpu.search import rnn_fusion as jfusion
from rasr_tpu.search.lookahead import build_bigram_lookahead as jax_build_bigram_lookahead
from rasr_tpu.search.streaming import StreamingDecoder as JaxStreamingDecoder
from rasr_tpu.search.tree import build_prefix_tree as jax_build_prefix_tree
from rasr_tpu_torch import convert
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu_torch.search.lookahead import build_bigram_lookahead
from rasr_tpu_torch.search.rnn_fusion import build_rnn_fusion, cell_step, word_scores
from rasr_tpu_torch.search.streaming import StreamingDecoder
from rasr_tpu_torch.search.tree import build_prefix_tree
from rasr_tpu_torch.synthetic import HashTying
from tests.test_rnn_fusion import _oracle_best
from tests.test_torch_decoder import (  # noqa: F401 (module fixtures)
    _assert_port_equals_jax, slice_b_systems,
)


@pytest.fixture(scope="module")
def jax_rnnlm():
    """tests/test_rnn_fusion.py's RNN LM (the reference's training)."""
    rng = np.random.default_rng(7)
    words = ["AB", "BA", "AA"]
    sents = [[words[rng.integers(0, 3)] for _ in range(rng.integers(1, 4))]
             for _ in range(40)]
    return JaxRnnLm.train_from_text(sents, embed_dim=8, hidden_dim=12, epochs=30)


@pytest.fixture(scope="module")
def rnnlm(jax_rnnlm):
    return convert.rnn_lm_from_flax(jax_rnnlm, device="cpu")


@pytest.fixture(scope="module")
def systems(jax_rnnlm, rnnlm):
    """tests/test_rnn_fusion.py's system (an order-5 LM over every 3-word
    sequence: vacuous truncation) in both packages."""
    lex = Lexicon()
    build_default_silence(lex)
    for orth, pron in (("AB", "a b"), ("BA", "b a"), ("AA", "a a")):
        lex.add_lemma([orth], [(pron.split(), 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    # hashed classes, one per tree state: tie-free path scores (the
    # reference's monophone tying ties the split between adjacent "a"s)
    tying = HashTying(211)
    trans = TransitionModel(
        speech=Tdp(loop=1.0, forward=0.0, skip=math.inf, exit=0.5),
        silence=Tdp(loop=0.2, forward=0.5, skip=math.inf, exit=0.3),
    )
    text = [list(t) for t in itertools.product(["AB", "BA", "AA"], repeat=3)]
    lm = NgramLm.train_from_text(text, order=5)
    ttree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    assert len(set(ttree.emission_class.tolist())) == ttree.num_states
    return dict(
        lex=lex, topo=topo, tying=tying, trans=trans, lm=lm, jtables=jax_compile_ngram(lm),
        jtree=jax_build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab),
        jfusion=jfusion.build_rnn_fusion(jax_rnnlm, lm.vocab, weight=0.6),
        ttree=ttree,
        tables=compile_ngram(lm), fusion=build_rnn_fusion(rnnlm, lm.vocab, weight=0.6,
                                                          device="cpu"))


def _cfg(**kw):
    return dict(beam=1e9, lm_scale=0.7, **kw)


def _decoders(s, kw, bigram=False):
    jla = tla = None
    if bigram:
        jla = jax_build_bigram_lookahead(s["jtree"], s["lm"], num_classes=4)
        tla = build_bigram_lookahead(s["ttree"], s["lm"], num_classes=4)
    return (jdec.TreeDecoder(s["jtree"], s["jtables"], jdec.BeamConfig(**kw), bigram_la=jla,
                             rnn_fusion=s["jfusion"]),
            TreeDecoder(s["ttree"], s["tables"], BeamConfig(**kw), bigram_la=tla,
                        rnn_fusion=s["fusion"], device="cpu"))


def _assert_same(got, want, rtol=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.words == b.words
        assert a.word_ends == b.word_ends
        assert a.record_ids == b.record_ids
        np.testing.assert_allclose(a.score, b.score, rtol=rtol)


def test_tables_match_jax(systems, jax_rnnlm, rnnlm):
    """build_rnn_fusion over the carried-across LM == the reference's
    tables (and the reference's tables carried across directly)."""
    want = jfusion.build_rnn_fusion(jax_rnnlm, systems["lm"].vocab, weight=0.6)
    for got in (systems["fusion"], convert.rnn_fusion_tables_from_jax(want, "cpu")):
        for name in ("emb", "wx", "wh", "b", "proj_w", "proj_b", "init_c", "init_h"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                       atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(got.word_map.numpy(), np.asarray(want.word_map))
        assert got.word_map.dtype == torch.int64
        assert (got.weight, got.oov_cost, got.end_wid) == (want.weight, want.oov_cost,
                                                           want.end_wid)
        assert got.hidden == want.hidden


def test_cell_step_and_word_scores_match_jax(systems):
    """cell_step / word_scores on seeded inputs == the reference's; the
    cell and projection reproduce the module's logits and -log softmax."""
    fus, jfus = systems["fusion"], systems["jfusion"]
    rng = np.random.default_rng(0)
    E, H = fus.wx.shape[0], fus.hidden
    x = rng.normal(size=(3, 4, E)).astype(np.float32)
    c = rng.normal(size=(3, 4, H)).astype(np.float32)
    h = rng.normal(size=(3, 4, H)).astype(np.float32)
    wid = rng.integers(0, fus.proj_b.shape[0], size=(3, 4))
    got = cell_step(fus, *(torch.as_tensor(a) for a in (x, c, h)))
    want = jfusion.cell_step(jfus, x, c, h)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(
        word_scores(fus, torch.as_tensor(h), torch.as_tensor(wid)).numpy(),
        np.asarray(jfusion.word_scores(jfus, h, wid)), atol=1e-5)


def test_cell_matches_the_module(systems, rnnlm):
    """The tables' cell + projection reproduce the port's LstmLm logits
    (same parameters) and word_scores its -log softmax (the reference's
    test_cell_matches_flax_module)."""
    fus = build_rnn_fusion(rnnlm, rnnlm.vocab, weight=1.0, device="cpu")
    toks = np.random.default_rng(0).integers(0, len(rnnlm.vocab), size=(2, 5))
    with torch.no_grad():
        logits_ref, _ = rnnlm.model(torch.as_tensor(toks))
    c = h = torch.zeros((2, fus.hidden))
    for t in range(toks.shape[1]):
        c, h = cell_step(fus, fus.emb[toks[:, t]], c, h)
        np.testing.assert_allclose((h @ fus.proj_w + fus.proj_b).numpy(),
                                   logits_ref[:, t].numpy(), atol=1e-5)
    wid = torch.tensor([1, 2])
    want = -torch.log_softmax(logits_ref[:, -1], dim=-1)[torch.arange(2), wid]
    np.testing.assert_allclose(word_scores(fus, h, wid).numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("variant", ["plain", "rsel_defer"])
def test_fused_decode_matches_oracle_and_jax(systems, jax_rnnlm, rng, variant):
    """Pruning off: the fused decode == the brute-force minimum over word
    sequences under am + lm_scale * ngram + weight * rnn, and == the JAX
    decoder."""
    s = systems
    M, T = s["tying"].num_classes, 7
    kw = _cfg(max_hyps=512, word_end_limit=64, root_hyps=512)
    if variant == "rsel_defer":
        kw.update(root_select=2048, deferred_emission=True)
    jax_dec, dec = _decoders(s, kw)
    for trial in range(2):
        emis = rng.uniform(0.0, 6.0, size=(1, T, M)).astype(np.float32)
        (res,) = dec.decode_scores(emis, np.array([T]))
        oracle_score, oracle_seq = _oracle_best(
            s["lex"], s["topo"], s["tying"], s["trans"], s["lm"], jax_rnnlm,
            s["fusion"].weight, emis, T, 0.7)
        np.testing.assert_allclose(res.score, oracle_score, rtol=1e-4, atol=1e-3)
        assert [lem.primary_orth for lem in res.lemmas] == list(oracle_seq), (variant, trial)
        _assert_same([res], jax_dec.decode_scores(emis, np.array([T])))


def test_fusion_changes_the_answer(systems, rng):
    """Across random emissions some decodes differ between the n-gram-only
    and the fused decoder; each fused result == the JAX decoder's."""
    s = systems
    M = s["tying"].num_classes
    kw = _cfg(max_hyps=512, word_end_limit=64, root_hyps=512)
    plain = TreeDecoder(s["ttree"], s["tables"], BeamConfig(**kw), device="cpu")
    jax_dec, dec = _decoders(s, kw)
    differs = 0
    for _ in range(6):
        emis = rng.uniform(0.0, 4.0, size=(1, 7, M)).astype(np.float32)
        (a,) = plain.decode_scores(emis, np.array([7]))
        (b,) = dec.decode_scores(emis, np.array([7]))
        _assert_same([b], jax_dec.decode_scores(emis, np.array([7])))
        if a.orth != b.orth or abs(a.score - b.score) > 1e-3:
            differs += 1
    assert differs > 0


def test_streamed_blocks_match_offline(systems, rng):
    """Block feeds with the pool compaction between them == the offline
    fused decode (== the JAX one, offline and streamed)."""
    s = systems
    M, T, B = s["tying"].num_classes, 9, 2
    kw = _cfg(max_hyps=128, word_end_limit=32, root_hyps=128)
    jax_dec, dec = _decoders(s, kw)
    emis = rng.uniform(0.0, 6.0, size=(B, T, M)).astype(np.float32)
    nfr = np.array([T, T - 3], np.int32)
    offline = dec.decode_scores(emis, nfr)
    _assert_same(offline, jax_dec.decode_scores(emis, nfr))
    sd = StreamingDecoder(dec).restart(B, n_frames=nfr)
    jsd = JaxStreamingDecoder(jax_dec).restart(B, n_frames=nfr)
    for lo in (0, 3, 6):
        sd.feed(emis[:, lo: lo + 3])
        jsd.feed(emis[:, lo: lo + 3])
    online = sd.finalize()
    _assert_same(online, offline, rtol=1e-5)
    _assert_same(online, jsd.finalize())


def test_streaming_pool_is_bounded(systems, rng):
    """The pool holds 2K + R x Tb rows after every feed, however many
    blocks are fed, and the stream's current best == the JAX stream's."""
    s = systems
    M = s["tying"].num_classes
    kw = _cfg(max_hyps=64, word_end_limit=16, root_hyps=64)
    jax_dec, dec = _decoders(s, kw)
    sd = StreamingDecoder(dec).restart(1)
    jsd = JaxStreamingDecoder(jax_dec).restart(1)
    Tb = 4
    cap = 2 * 64 + 16 * Tb
    for _ in range(6):
        block = rng.uniform(0.0, 6.0, size=(1, Tb, M)).astype(np.float32)
        sd.feed(block)
        jsd.feed(block)
        assert sd._carry.cs.shape[1] == sd._carry.hs.shape[1] == cap
    (got,) = sd.finalize()
    assert got.score < 1e29
    _assert_same([got], jsd.finalize())


def test_fusion_composes_with_bigram_lookahead(systems, rng):
    """Fusion + bigram-lookahead shaping: the shaping cancels (the fused
    scores of fusion alone), offline and streamed, == the JAX decoder."""
    s = systems
    M, T, B = s["tying"].num_classes, 8, 2
    emis = rng.uniform(0.0, 6.0, size=(B, T, M)).astype(np.float32)
    nfr = np.full(B, T, np.int32)
    kw = _cfg(max_hyps=64, word_end_limit=16, root_hyps=64)
    plain = _decoders(s, kw)[1].decode_scores(emis, nfr)
    jax_dec, dec = _decoders(s, kw, bigram=True)
    both = dec.decode_scores(emis, nfr)
    for a, b in zip(plain, both):
        np.testing.assert_allclose(b.score, a.score, rtol=1e-5, atol=1e-4)
        assert a.words == b.words
    _assert_same(both, jax_dec.decode_scores(emis, nfr))
    sd = StreamingDecoder(dec).restart(B, n_frames=nfr)
    for lo in (0, 4):
        sd.feed(emis[:, lo: lo + 4])
    _assert_same(sd.finalize(), both, rtol=1e-5)


def test_beam_partitioning_with_fusion_raises(systems):
    """Fusion under beam partitioning is ported and equals the JAX decoder
    (tests/test_torch_parallel_decode.py, over a gloo world); without a mesh
    the beam axis raises, as the reference asserts."""
    dec = _decoders(systems, _cfg(max_hyps=64, word_end_limit=16, root_hyps=64))[1]
    with pytest.raises(ValueError, match="beam_axis requires a mesh"):
        dec.decode_scores(np.zeros((1, 2, systems["tying"].num_classes), np.float32), [2],
                          beam_axis="model")


#: the production beam's shape at a small size: root select, deferred
#: emission, compact branch slots, a root-arc limit; K, R, H, Kb bind
PRODUCTION = dict(max_hyps=10, word_end_limit=4, root_hyps=3, branch_hyps=3, root_select=4,
                  root_arc_limit=2, deferred_emission=True, branch_width=4, lm_scale=0.7)


@pytest.fixture(scope="module")
def production_rnn(slice_b_systems):
    """An RNN LM over the tie-free slice-B system's vocabulary (trained by
    the reference; one word left out so that the OOV branch runs), as the
    JAX and the port fusion tables."""
    tying, lm, jtree, ttree, lex = slice_b_systems[True]
    words = [w for w in lm.vocab if not w.startswith("<") and w != "</s>" and w != "CA"]
    rng = np.random.default_rng(3)
    sents = [[words[i] for i in rng.integers(0, len(words), size=rng.integers(1, 5))]
             for _ in range(60)]
    jlm = JaxRnnLm.train_from_text(sents, embed_dim=8, hidden_dim=12, epochs=20)
    jfus = jfusion.build_rnn_fusion(jlm, lm.vocab, weight=0.8)
    tfus = build_rnn_fusion(convert.rnn_lm_from_flax(jlm, "cpu"), lm.vocab, weight=0.8,
                            device="cpu")
    assert int((tfus.word_map < 0).sum()) >= 1
    return jfus, tfus


@pytest.mark.parametrize("seed", [400, 401])
def test_production_beam_matches_jax(slice_b_systems, production_rnn, seed):
    """Binding production-shaped beam under fusion: every frame's records,
    the best paths and the final beams (with the fused </s> costs) ==
    the JAX decoder's."""
    tying, lm, jtree, ttree, _ = slice_b_systems[True]
    _assert_port_equals_jax(jtree, ttree, lm, tying.num_classes, PRODUCTION, seed,
                            rnn=production_rnn)
