"""PyTorch port vs JAX: the lattice toolkit (``lattice/flf.py``).

The port's copy runs over the port's lattices; the reference over its own.
Both come from the same tie-free decodes (``tests/test_torch_lattice.py``'s
cases), so every function gives the same answer: best and n-best paths
(the same arcs, costs within 1e-4 relative), forward-backward totals and
arc posteriors (1e-4), posterior pruning, LM rescoring with an ``NgramLm``
(read from one ARPA file by both packages) and with an ``RnnLm`` (the
reference's carried across), confusion networks and their decodes, the
time-frame CN and word confidences, rescaling, lemma mapping, union and
intersection.
"""

import numpy as np
import pytest

from rasr_tpu.lattice import flf as jflf
from rasr_tpu.models.lm.arpa import NgramLm as JaxNgramLm
from rasr_tpu.models.lm.rnn import RnnLm as JaxRnnLm
from rasr_tpu_torch import convert
from rasr_tpu_torch.lattice import flf
from rasr_tpu_torch.models.lm.arpa import NgramLm
from tests.test_torch_decoder import slice_b_systems, slice_c_systems  # noqa: F401
from tests.test_torch_lattice import CASES, _lattices

FLF_CASES = ["slice-b:root-select-deferred", "slice-b:bench-canary-config",
             "slice-c:across-word"]


@pytest.fixture(scope="module", params=FLF_CASES)
def lattices(request, slice_b_systems, slice_c_systems):  # noqa: F811
    kind, name, n, streamed = CASES[request.param]
    systems = slice_b_systems if kind == "b" else slice_c_systems
    got, want, _, _ = _lattices(systems, kind, name, n, streamed)
    return got, want


@pytest.fixture(scope="module")
def lms(slice_b_systems, tmp_path_factory):  # noqa: F811
    """The decode's trigram LM read from one ARPA file by both packages,
    and an RNN LM over its words (the reference's, carried across)."""
    _, lm, *_ = slice_b_systems[True]
    path = str(tmp_path_factory.mktemp("flf") / "lm.arpa")
    lm.write_arpa(path)
    words = sorted(w for w in lm.vocab if not w.startswith("<") and w != "</s>")
    rng = np.random.default_rng(5)
    sents = [[words[i] for i in rng.integers(0, len(words), size=rng.integers(1, 5))]
             for _ in range(40)]
    jrnn = JaxRnnLm.train_from_text(sents, embed_dim=8, hidden_dim=12, epochs=10)
    return (JaxNgramLm.read_arpa(path), NgramLm.read_arpa(path),
            jrnn, convert.rnn_lm_from_flax(jrnn, device="cpu"))


def _arcs(path):
    return [(a.from_node, a.to_node, a.lemma) for a in path]


def _assert_same_lattice(a, b):
    assert a.num_nodes == b.num_nodes
    np.testing.assert_array_equal(a.node_time, b.node_time)
    assert a.lemma_orths == b.lemma_orths
    assert _arcs(a.arcs) == _arcs(b.arcs)
    np.testing.assert_allclose([x.am_score for x in a.arcs], [x.am_score for x in b.arcs],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose([x.lm_score for x in a.arcs], [x.lm_score for x in b.arcs],
                               rtol=1e-4, atol=1e-3)
    assert sorted(a.final_scores) == sorted(b.final_scores)
    np.testing.assert_allclose([a.final_scores[k] for k in sorted(a.final_scores)],
                               [b.final_scores[k] for k in sorted(b.final_scores)],
                               rtol=1e-4, atol=1e-3)


def test_best_and_n_best(lattices):
    for got, want in zip(*lattices):
        for scales in ((1.0, 1.0), (1.0, 0.5)):
            (c, p), (wc, wp) = flf.best_path(got, *scales), jflf.best_path(want, *scales)
            np.testing.assert_allclose(c, wc, rtol=1e-4)
            assert _arcs(p) == _arcs(wp)
            g, w = flf.n_best(got, 5, *scales), jflf.n_best(want, 5, *scales)
            assert [_arcs(p) for _, p in g] == [_arcs(p) for _, p in w]
            np.testing.assert_allclose([c for c, _ in g], [c for c, _ in w], rtol=1e-4)


def test_forward_backward_and_posterior_prune(lattices):
    for got, want in zip(*lattices):
        total, post = flf.forward_backward(got, 1.0, 0.7)
        wtotal, wpost = jflf.forward_backward(want, 1.0, 0.7)
        np.testing.assert_allclose(total, wtotal, rtol=1e-4)
        np.testing.assert_allclose(post, wpost, atol=1e-4)
        for thr in (1e-3, 0.2):
            _assert_same_lattice(flf.posterior_prune(got, thr), jflf.posterior_prune(want, thr))


def test_rescore_with_ngram_lm(lattices, lms):
    jngram, ngram, _, _ = lms
    for got, want in zip(*lattices):
        synt = {i: ngram.vocab.get(o) for i, o in enumerate(got.lemma_orths)}
        for keep_old in (False, True):
            _assert_same_lattice(flf.rescore_lm(got, ngram, synt, keep_old),
                                 jflf.rescore_lm(want, jngram, synt, keep_old))


def test_rescore_with_rnn_lm(lattices, lms):
    """The RNN LM expands each lattice by full history; words the RNN LM
    lacks (id None: no LM score) pass through."""
    _, _, jrnn, rnn = lms
    for got, want in zip(*lattices):
        synt = {i: rnn.vocab.get(o) for i, o in enumerate(got.lemma_orths)}
        r, w = flf.rescore_lm(got, rnn, synt), jflf.rescore_lm(want, jrnn, synt)
        _assert_same_lattice(r, w)
        (c, p), (wc, wp) = flf.best_path(r), jflf.best_path(w)
        np.testing.assert_allclose(c, wc, rtol=1e-4)
        assert _arcs(p) == _arcs(wp)


def test_confusion_networks(lattices):
    for got, want in zip(*lattices):
        slots, assign = flf.confusion_network(got, 1.0, 0.7, return_assignment=True)
        wslots, wassign = jflf.confusion_network(want, 1.0, 0.7, return_assignment=True)
        assert [(s.start, s.end) for s in slots] == [(s.start, s.end) for s in wslots]
        for s, ws in zip(slots, wslots):
            assert [h for h, _ in s.hypotheses] == [h for h, _ in ws.hypotheses]
            np.testing.assert_allclose([p for _, p in s.hypotheses],
                                       [p for _, p in ws.hypotheses], atol=1e-4)
        assert assign == wassign
        assert flf.cn_decode(slots) == jflf.cn_decode(wslots)
        frames, wframes = flf.time_frame_cn(got), jflf.time_frame_cn(want)
        assert [sorted(f) for f in frames] == [sorted(f) for f in wframes]
        for f, wf in zip(frames, wframes):
            np.testing.assert_allclose([f[k] for k in sorted(f)], [wf[k] for k in sorted(wf)],
                                       atol=1e-4)
        for thr in (0.0, 0.5):
            assert flf.fcn_decode(frames, thr) == jflf.fcn_decode(wframes, thr)
        conf, wconf = flf.word_confidence(got), jflf.word_confidence(want)
        assert [w for w, _ in conf] == [w for w, _ in wconf]
        np.testing.assert_allclose([c for _, c in conf], [c for _, c in wconf], atol=1e-4)


def test_scale_map_union_intersect(lattices):
    got, want = lattices
    for g, w in zip(got, want):
        _assert_same_lattice(flf.scale_scores(g, 0.5, 2.0), jflf.scale_scores(w, 0.5, 2.0))
        orth_map = {o: o.lower() for o in g.lemma_orths[::2]}
        _assert_same_lattice(flf.map_lemmas(g, orth_map), jflf.map_lemmas(w, orth_map))
        _assert_same_lattice(flf.intersect(g, got[0]), jflf.intersect(w, want[0]))
    _assert_same_lattice(flf.union(got), jflf.union(want))
