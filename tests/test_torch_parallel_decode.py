"""PyTorch port vs JAX: the decoder over a mesh (``decode_scores(mesh=...)``
and the partitioned beam, ``beam_axis="model"``).

One gloo world of 4 CPU ranks (``tests/torch_parallel_ranks.py``) runs
every case; the JAX side runs on conftest's 8 virtual CPU devices. The
reference's partitioned-beam gates (``tests/test_decoder.py:273,772``,
``tests/test_rnn_fusion.py:277``, ``tests/test_wfst.py:149``: limits that
cover each slice, the exactness precondition) and its data-parallel
lattice chain (``tests/test_lattice.py:233-280``). On every rank the
port's decode equals the JAX decode over its mesh and the JAX
single-device decode (words and word ends exact, scores within 1e-5
relative; 1e-4 relative + 1e-3 under a bigram lookahead, as the
reference); the data-parallel handle's lattices equal the port's
single-device decode's, arc for arc.
"""

import dataclasses
import math

import numpy as np
import pytest

from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.fsa.automaton import Automaton as JaxAutomaton
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.models.tying import MonophoneStateTying
from rasr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rasr_tpu.search import decoder as jdec
from rasr_tpu.search.lookahead import build_bigram_lookahead as jax_build_bigram_lookahead
from rasr_tpu.search.tree import build_prefix_tree as jax_build_prefix_tree
from rasr_tpu.search.wfst import compile_wfst as jax_compile_wfst
from rasr_tpu_torch.fsa.automaton import Automaton
from rasr_tpu_torch.lattice.flf import best_path, rescore_lm
from rasr_tpu_torch.lattice.lattice import decoder_lattice, lattice_from_records
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder, bigram_to_device
from rasr_tpu_torch.search.lookahead import build_bigram_lookahead
from rasr_tpu_torch.search.tree import build_prefix_tree
from rasr_tpu_torch.search.wfst import compile_wfst
from tests.test_decoder import _bigram_la_setup
from tests.test_torch_rnn_fusion import jax_rnnlm, rnnlm, systems  # noqa: F401 (fixtures)
from tests.test_torch_wfst import _cyclic_grammar_fsa, _Lemma
from tests.torch_parallel_ranks import run_world

RTOL = 1e-5


def _monophone_system():
    """tests/test_decoder.py's ``setup``."""
    lex = Lexicon()
    build_default_silence(lex)
    for orth, pron in (("AB", "a b"), ("BA", "b a"), ("AA", "a a")):
        lex.add_lemma([orth], [(pron.split(), 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    trans = TransitionModel(
        speech=Tdp(loop=1.0, forward=0.0, skip=math.inf, exit=0.5),
        silence=Tdp(loop=0.2, forward=0.5, skip=math.inf, exit=0.3),
    )
    lm = NgramLm.train_from_text([["AB", "BA"], ["AB", "AA"], ["BA", "AB"], ["AB", "BA"]], order=2)
    return (build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab),
            jax_build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab), lm, tying)


def _wfst_system():
    """tests/test_wfst.py::test_wfst_bigram_lookahead_partitioned_exact's
    cyclic grammar and bigram LM."""
    words = ["A", "B", "C", "D"]
    lemmas = [_Lemma(w) for w in words]
    rng = np.random.default_rng(5)
    sents = []
    for _ in range(60):
        mid = [words[1 + int(rng.integers(2))] for _ in range(int(rng.integers(0, 4)))]
        sents.append(["A"] + mid + ["D"])
    lm = NgramLm.train_from_text(sents, order=2)
    kw = dict(num_classes=4, lemmas=lemmas, loop_cost=0.3,
              lm_words={i: lm.vocab[w] for i, w in enumerate(words)})
    return (compile_wfst(_cyclic_grammar_fsa(Automaton), **kw),
            jax_compile_wfst(_cyclic_grammar_fsa(JaxAutomaton), **kw), lm)


def _conformer_emissions(rng, M):
    """The reference's hybrid scorer (a length-masked conformer) on its
    draws: tests/test_lattice.py::test_config5_hybrid_sharded_decode_lattice_rescore."""
    import jax
    import jax.numpy as jnp

    from rasr_tpu.models.nn import ConformerEncoderNet, NnHybridScorer, StatePriors

    model = ConformerEncoderNet(num_classes=M, d_model=8, num_blocks=1, num_heads=2,
                                conv_kernel=3)
    feats = rng.normal(size=(4, 10, 6)).astype(np.float32) * 3.0
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(feats))["params"]
    priors = StatePriors(np.log(np.full(M, 1.0 / M, np.float32)))
    n = np.array([10, 8, 10, 7])
    return np.asarray(NnHybridScorer(model, params, priors, scale=1.0)(feats, lengths=n)), n


def _rank_tree(tree):
    """The tree as the ranks get it: without the lemma objects (the ranks
    import only the port; results and lattices are read here)."""
    return dataclasses.replace(tree, lemmas=[])


@pytest.fixture(scope="module")
def cases(systems):  # noqa: F811
    out = {}
    rng = np.random.default_rng(0)

    ttree, jtree, lm, tying = _monophone_system()
    exact = dict(max_hyps=64, word_end_limit=16, root_hyps=64, branch_hyps=64, lm_scale=0.7)
    emis = rng.uniform(0.0, 8.0, size=(2, 12, tying.num_classes)).astype(np.float32)
    n = np.array([12, 9], np.int32)
    out["partitioned"] = dict(
        shape=(2, 2), trees=(ttree, jtree), lm=lm, cfg=exact, emis=emis, n=n,
        jax_mesh=dict(data=2, model=4))

    _, _, _, _, blm, _, _, jbla = _bigram_la_setup()
    blex, btopo, btying, btrans = _bigram_la_setup()[:4]
    uni = {wid: blm.score((), wid) for wid in blm.vocab.values()}
    btree = build_prefix_tree(blex, btying, btopo, btrans, lm_vocab=blm.vocab, lm_unigrams=uni)
    bjtree = jax_build_prefix_tree(blex, btying, btopo, btrans, lm_vocab=blm.vocab,
                                   lm_unigrams=uni)
    emis = rng.uniform(0.0, 8.0, size=(2, 10, btying.num_classes)).astype(np.float32)
    out["bigram"] = dict(
        shape=(1, 4), trees=(btree, bjtree), lm=blm, cfg=exact, emis=emis,
        n=np.array([10, 7], np.int32), jax_mesh=dict(data=2, model=4),
        bla=(build_bigram_lookahead(btree, blm, num_classes=8), jbla), tol=(1e-4, 1e-3))

    s = systems
    emis = rng.uniform(0.0, 6.0, size=(2, 8, s["tying"].num_classes)).astype(np.float32)
    out["rnn-fusion"] = dict(
        shape=(2, 2), trees=(s["ttree"], s["jtree"]), lm=s["lm"],
        cfg=dict(max_hyps=64, beam=1e9, word_end_limit=16, root_hyps=64, branch_hyps=64,
                 lm_scale=0.7),
        emis=emis, n=np.array([8, 6], np.int32), jax_mesh=dict(data=2, model=4),
        rnn=(s["fusion"], s["jfusion"]), tol=(RTOL, 1e-4))

    wtree, wjtree, wlm = _wfst_system()
    emis = np.random.default_rng(1).uniform(0.0, 4.0, size=(2, 10, 4)).astype(np.float32)
    out["wfst"] = dict(
        shape=(1, 4), trees=(wtree, wjtree), lm=wlm,
        cfg=dict(max_hyps=32, word_end_limit=16, root_hyps=32, branch_hyps=32, lm_scale=1.0),
        emis=emis, n=np.array([10, 7], np.int32), jax_mesh=dict(data=2, model=4),
        bla=(build_bigram_lookahead(wtree, wlm, num_classes=6),
             jax_build_bigram_lookahead(wjtree, wlm, num_classes=6)), tol=(1e-4, 1e-3))

    # the data-parallel lattice chain: AB / BA, a bigram LM, conformer emissions
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    ltying = MonophoneStateTying(lex, topo)
    lm2 = NgramLm.train_from_text([["AB", "BA"], ["BA", "AB"]], order=2)
    emis, n = _conformer_emissions(np.random.default_rng(0), ltying.num_classes)
    out["dp-lattice"] = dict(
        shape=(4, 1), lm=lm2, cfg=dict(max_hyps=64, word_end_limit=16, lm_scale=1.0),
        trees=(build_prefix_tree(lex, ltying, topo, TransitionModel(), lm_vocab=lm2.vocab),
               jax_build_prefix_tree(lex, ltying, topo, TransitionModel(), lm_vocab=lm2.vocab)),
        emis=emis, n=n, jax_mesh=dict(data=4, model=1), records=True)
    return out


def _rank_case(name, c):
    bla = c.get("bla", (None, None))[0]
    kw = dict(tree=_rank_tree(c["trees"][0]), lm=compile_ngram(c["lm"]),
              cfg=BeamConfig(**c["cfg"]), emis=c["emis"], n=c["n"],
              beam_axis=None if c.get("records") else "model",
              bla=None if bla is None else bigram_to_device(bla, c["trees"][0], "cpu"),
              rnn=c.get("rnn", (None, None))[0], records=bool(c.get("records")))
    return (name, "decode", c["shape"], kw)


def _corpus(tmp):
    """5 wavs of 0.5-1 s (batches of 2, 2 and 1: shares of 1 or none on a
    2-way data axis), orths from the synthetic setup's words."""
    from rasr_tpu_torch.corpus.audio import write_wav

    rng = np.random.default_rng(8)
    xml = ['<corpus name="c">']
    for i in range(5):
        wav = tmp / f"r{i}.wav"
        write_wav(str(wav), (rng.normal(size=int(rng.uniform(0.5, 1.0) * 16000)) * 0.1)
                  .astype(np.float32))
        orth = " ".join(f"w{int(j)}" for j in rng.integers(0, 30, size=3))
        xml.append(f'<recording name="r{i}" audio="{wav}"><segment name="s"><orth>{orth}'
                   "</orth></segment></recording>")
    (tmp / "c.corpus").write_text("".join(xml) + "</corpus>")
    return str(tmp / "c.corpus")


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode-world")
    c = cases["partitioned"]
    extra = [
        # 3 utterances over 4 data ranks: shares of 1, the last rank none
        ("uneven", "decode", (4, 1), dict(
            tree=_rank_tree(c["trees"][0]), lm=compile_ngram(c["lm"]),
            cfg=BeamConfig(**c["cfg"]), emis=np.concatenate([c["emis"], c["emis"][:1]]),
            n=np.array([12, 9, 5], np.int32))),
        ("recognizer", "recognizer", (2, 2), dict(corpus_path=_corpus(tmp), batch_size=2)),
    ]
    return run_world(tmp, [_rank_case(name, c) for name, c in cases.items()] + extra)


def _jax_decoder(c, shaped=True):
    bla = c.get("bla", (None, None))[1] if shaped else None
    return jdec.TreeDecoder(c["trees"][1], jax_compile_ngram(c["lm"]), jdec.BeamConfig(**c["cfg"]),
                            bigram_la=bla, rnn_fusion=c.get("rnn", (None, None))[1])


def _port_decoder(c):
    bla = c.get("bla", (None, None))[0]
    return TreeDecoder(c["trees"][0], compile_ngram(c["lm"]), BeamConfig(**c["cfg"]),
                       bigram_la=bla, rnn_fusion=c.get("rnn", (None, None))[0], device="cpu")


def _assert_results(got, want, tol, word_ends=True):
    rtol, atol = tol
    for a, b in zip(got, want):
        assert a.words == b.words, (a.words, b.words)
        if word_ends:
            assert a.word_ends == b.word_ends
        np.testing.assert_allclose(a.score, b.score, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["partitioned", "bigram", "rnn-fusion", "wfst"])
def test_partitioned_beam_matches_jax(cases, world, name):
    """The beam partitioned over ``model`` (a per-frame all_gather merge)
    on every rank == the JAX partitioned decode == the single-device
    decode (unshaped under a lookahead, as the reference's gates)."""
    c = cases[name]
    tol = c.get("tol", (RTOL, 0.0))
    port = _port_decoder(c)
    mesh = jax_make_mesh(**c["jax_mesh"])
    want = _jax_decoder(c).decode_scores(c["emis"], c["n"], mesh=mesh, beam_axis="model")
    single = _jax_decoder(c, shaped=False).decode_scores(c["emis"], c["n"])
    _assert_results(want, single, tol, word_ends="bla" not in c)
    for out in world[name]:
        got = port.results_from_walk(out["walk"])
        _assert_results(got, want, tol)
        _assert_results(got, single, tol, word_ends="bla" not in c)
    _assert_results(port.decode_scores(c["emis"], c["n"]), want, tol)


def test_dp_decode_lattices_match_jax(cases, world):
    """DP decode over a (4, 1) mesh == the JAX mesh decode and the
    single-device one (words and scores: the monophone tying ties word
    boundaries, as the reference's gate allows); the assembled handle's
    lattices (each utterance's own record rows) == the port's
    single-device lattices arc for arc, the first holds the best path, and
    rescoring it with a trigram finds the best path of an exhaustive
    enumeration."""
    import jax

    c = cases["dp-lattice"]
    port = _port_decoder(c)
    jdecoder = _jax_decoder(c)
    mesh = jax_make_mesh(**c["jax_mesh"], devices=jax.devices()[:4])
    want = jdecoder.decode_scores(c["emis"], c["n"], mesh=mesh)
    single = jdecoder.decode_scores(c["emis"], c["n"])
    _assert_results(want, single, (RTOL, 0.0), word_ends=False)
    handle = port.decode_scores_device(c["emis"], c["n"])
    lemmas = c["trees"][0].lemmas
    R = port.cfg.word_end_limit
    for out in world["dp-lattice"]:
        _assert_results(port.results_from_walk(out["walk"]), want, (RTOL, 0.0), word_ends=False)
        records = tuple(out[f"rec{i}"] for i in range(6))
        finals = tuple(out[f"fin{i}"] for i in range(5))
        for b in range(len(c["n"])):
            lat = lattice_from_records(records, b, R, lemmas, finals, int(out["n_frames"][b]))
            ref = decoder_lattice(handle, lemmas, b)
            assert lat.num_nodes == ref.num_nodes
            np.testing.assert_array_equal(lat.node_time, ref.node_time)
            assert lat.final_scores == ref.final_scores
            assert [(a.from_node, a.to_node, a.lemma, a.am_score, a.lm_score)
                    for a in lat.arcs] == [(a.from_node, a.to_node, a.lemma, a.am_score,
                                            a.lm_score) for a in ref.arcs]
            if b == 0:
                np.testing.assert_allclose(best_path(lat)[0], single[0].score, rtol=1e-4,
                                           atol=1e-3)
                lat0 = lat
    lm3 = NgramLm.train_from_text([["AB", "BA", "AB"], ["BA", "AB", "AB"], ["AB", "AB", "BA"]],
                                  order=3)
    synt = {i: lm3.vocab.get(lemma.primary_orth) for i, lemma in enumerate(lemmas)}
    got_score, _ = best_path(rescore_lm(lat0, lm3, synt))
    out_arcs, best = lat0.out_arcs(), [np.inf]

    def dfs(node, hist, am):
        if node in lat0.final_scores:
            best[0] = min(best[0], am + lm3.sentence_end_score(hist))
        for ai in out_arcs[node]:
            a = lat0.arcs[ai]
            wid = synt.get(a.lemma)
            if wid is None:
                dfs(a.to_node, hist, am + a.am_score)
            else:
                dfs(a.to_node, lm3.extended_history(hist, wid),
                    am + a.am_score + lm3.score(hist, wid))

    dfs(0, lm3.start_history(), 0.0)
    np.testing.assert_allclose(got_score, best[0], rtol=1e-5, atol=1e-4)


def test_dp_decode_uneven_shares(cases, world):
    """3 utterances over 4 data ranks (the last rank decodes only padding)
    == the single-device decode of both packages."""
    c = cases["partitioned"]
    emis = np.concatenate([c["emis"], c["emis"][:1]])
    n = np.array([12, 9, 5], np.int32)
    port = _port_decoder(c)
    want = _jax_decoder(c).decode_scores(emis, n)
    _assert_results(port.decode_scores(emis, n), want, (RTOL, 0.0))
    for out in world["uneven"]:
        _assert_results(port.results_from_walk(out["walk"]), want, (RTOL, 0.0))


def test_recognizer_over_the_mesh(world):
    """``OfflineRecognizer(mesh=)`` over a (2, 2) mesh, batches of 2, 2
    and 1: every rank returns the lone recognizer's words for every
    segment, evaluates its data share, and the shares' WER counters sum
    (``psum_counters``) to the lone run's."""
    for out in world["recognizer"]:
        assert list(out["mesh"]) == list(out["alone"]) and len(out["alone"]) == 5
        np.testing.assert_array_equal(out["merged"], out["alone_counts"])
        assert 0 < out["mesh_counts"][1] < out["alone_counts"][1]
