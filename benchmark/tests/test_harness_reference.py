"""The plain reference agrees with the port at a tiny size on the CPU."""

import itertools

import numpy as np
import pytest
import torch

from benchmark import spec, system, traffic
from benchmark.jobs import train as train_job
from benchmark.reference import conformer as rconf
from benchmark.reference import decode as rdec
from benchmark.reference import frontend as rfe
from benchmark.reference import gmm as rgmm
from benchmark.reference import search as rsearch
from benchmark.reference import train as rtrain
from benchmark.tests.tiny import tiny_run


@pytest.fixture(scope="module")
def gmm_case():
    r = tiny_run("gmm5k-decode")
    d = system.draw(r.cfg, r.seed)
    s = system.build(r.cfg, d, "cpu")
    x, lengths, n = traffic.audio_batch(r.traffic, 16000, r.seed, 0, "cpu")
    feats, nf = s.frontend(x, lengths)
    em = s.scorer(feats)
    return r, d, s, x, n, feats, nf, em


def test_features_and_gmm_scores(gmm_case):
    r, d, s, x, n, feats, nf, em = gmm_case
    for b in range(len(n)):
        k = int(nf[b])
        assert k == rfe.num_frames(int(n[b]), r.cfg)
        rf = rfe.features(x[b, : n[b]].numpy(), d.lda, r.cfg)
        assert np.abs(feats[b, :k].numpy() - rf).max() < 1e-4
        re = rgmm.scores(torch.from_numpy(rf), d.acoustic, 1e-4)
        assert (em[b, :k].double() - re).abs().max() < 1e-3


def test_decode_score_is_the_best_score_of_its_words(gmm_case):
    r, d, s, x, n, feats, nf, em = gmm_case
    model = rdec.Model(r.cfg, d.words, d.vocab, d.ngrams)
    for b, res in enumerate(s.decoder.decode_scores(em, nf)):
        k = int(nf[b])
        lemmas = [lem.primary_orth for lem in res.lemmas]
        ref = rdec.path_score(model, lemmas, res.word_ends, k, em[b, :k].double().numpy())
        # the search may prune its path's best alignment (a worse score),
        # never score better than the best path of its own words
        assert ref - res.score < 1e-2, (lemmas, res.word_ends)
        bad = list(lemmas)
        bad[len(bad) // 2] = "w0" if bad[len(bad) // 2] != "w0" else "w1"
        assert abs(rdec.path_score(model, bad, res.word_ends, k, em[b, :k].double().numpy())
                   - res.score) > 1.0


@pytest.mark.parametrize("silence_bias", [0.0, -3.0])
def test_the_word_loop_finds_the_best_of_every_path(silence_bias):
    """Three words and a silence over six frames: the exact search equals
    the least :func:`path_score` over every word sequence and segmentation."""
    cfg = spec.load_json(spec.ROOT / "benchmark/configs/rasr-gmm-5k.json")
    cfg["lexicon"]["num_phones"] = 3
    cfg["tying"]["num_classes"] = 7
    words = [("w0", ["p0"]), ("w1", ["p1", "p2"]), ("w2", ["p2"])]
    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2, "w0": 3, "w1": 4, "w2": 5}
    rng = np.random.default_rng(5)
    ngrams = {(i,): (float(rng.uniform(0.1, 2)), float(rng.uniform(0, 1))) for i in range(6)}
    for a, b in [(0, 3), (3, 4), (4, 1), (5, 5), (0, 5)]:
        ngrams[(a, b)] = (float(rng.uniform(0.1, 3)), 0.0)
    cfg["beam"]["lm_scale"] = 1.0
    model = rdec.Model(cfg, words, vocab, ngrams)
    loop = rsearch.WordLoop(model, words, "cpu")
    T, orths = 6, [w for w, _ in words] + [rdec.SILENCE]
    sil_class = model.chain(rdec.SILENCE)[0][0][0]
    for _ in range(3):
        emis = rng.uniform(0, 5, size=(T, 7))
        emis[:, sil_class] += silence_bias
        want = min(rdec.path_score(model, list(seq), list(cuts) + [T - 1], T, emis)
                   for k in range(1, T + 1) for cuts in itertools.combinations(range(T - 1), k - 1)
                   for seq in itertools.product(orths, repeat=k))
        got, path, ends = loop.best(torch.from_numpy(emis))
        assert abs(got - want) < 1e-9
        assert abs(rdec.path_score(model, path, ends, T, emis) - got) < 1e-9


def test_the_decode_scores_no_better_than_the_best_path(gmm_case):
    r, d, s, x, n, feats, nf, em = gmm_case
    model = rdec.Model(r.cfg, d.words, d.vocab, d.ngrams)
    loop = rsearch.WordLoop(model, d.words, "cpu")
    for b, res in enumerate(s.decoder.decode_scores(em, nf)):
        e = em[b, : int(nf[b])].double()
        best, path, ends = loop.best(e)
        assert best - res.score < 1e-2
        assert abs(rdec.path_score(model, path, ends, int(nf[b]), e.numpy()) - best) < 1e-6


@pytest.mark.parametrize("cell", ["gmm5k-decode", "conformer-decode"])
def test_a_beam_that_holds_every_hypothesis_finds_the_best_path(cell):
    """Twenty words and a beam wider than every (state, history) pair: the
    decoder prunes nothing and returns the word loop's best path."""
    r = tiny_run(cell)
    r.cfg["lexicon"].update(num_words=20, num_phones=8)
    r.cfg["tying"]["num_classes"] = 60
    r.cfg["beam"].update(max_hyps=8192, root_select=0, branch_hyps=0, root_hyps=8192,
                         word_end_limit=8192, root_arc_limit=0, deferred_emission=False)
    d = system.draw(r.cfg, r.seed)
    w = spec.model(r.cfg).weights(r.cfg, r.seed, "cpu")
    s = system.build(r.cfg, d, "cpu", w)
    x, lengths, n = traffic.audio_batch(dict(r.traffic, batch=3, min_s=1.0, max_s=2.0), 16000,
                                        r.seed, 0, "cpu")
    feats, nf = s.frontend(x, lengths)
    em = s.scorer(feats, lengths=nf)
    loop = rsearch.WordLoop(rdec.Model(r.cfg, d.words, d.vocab, d.ngrams), d.words, "cpu")
    for b, res in enumerate(s.decoder.decode_scores(em, nf)):
        best, path, ends = loop.best(em[b, : int(nf[b])].double())
        assert abs(res.score - best) < 1e-2
        assert [lem.primary_orth for lem in res.lemmas] == path
        assert list(res.word_ends) == ends


def test_conformer_logits():
    r = tiny_run("conformer-decode")
    cfg = r.cfg
    cfg["conformer"]["compute_dtype"] = "float32"
    w = spec.model(cfg).weights(cfg, r.seed, "cpu")
    s = system.build(cfg, system.draw(cfg, r.seed), "cpu", w, decoder=False)
    x = torch.randn(2, 37, 45, generator=torch.Generator().manual_seed(3))
    got = s.scorer.model(x, lengths=torch.tensor([37, 21]))
    for b, k in ((0, 37), (1, 21)):
        want = rconf.logits(x[b, :k], w, cfg)
        assert (got[b, :k] - want).abs().max() < 1e-4


def test_training_steps():
    r = tiny_run("conformer-train-ce")
    cfg = r.cfg
    cfg["conformer"]["compute_dtype"] = "float32"
    w = spec.model(cfg).weights(cfg, r.seed, "cpu")
    trainer = train_job.build(cfg, w, "cpu")
    pool = traffic.chunk_pool(r.traffic, 45, 300, r.seed, "cpu")[:3]
    losses = [float(trainer._update(*b)[0]) for b in pool]
    ref_losses, grad, change = rtrain.steps(rconf.logits, w, pool, cfg)
    assert np.allclose(losses, ref_losses, atol=1e-5)
    names = list(w)
    moved = {n: p.detach() - w[n] for n, p in trainer.model.named_parameters()}
    keep = [n for n in names if float(grad[n].norm()) > 1e-3 * float(np.median(
        [float(grad[m].norm()) for m in names]))]
    assert train_job.leaf_gap(moved, change, keep) < 1e-3


def test_alignment_graph_and_statistics(gmm_case):
    from rasr_tpu_torch.align.aligner import BatchAligner
    from rasr_tpu_torch.align.graph import build_linear_graph
    from rasr_tpu_torch.train import em

    from benchmark.reference import align as ralign

    r, d, s, x, n, feats, nf, em_scores = gmm_case
    lex, topo, trans, tying = system.port_lexicon(r.cfg, d)
    model = rdec.Model(r.cfg, d.words, d.vocab, d.ngrams)
    orths = traffic.transcripts(dict(r.traffic, words=[2, 4]), [w for w, _ in d.words],
                                r.seed, 0)
    graphs = [build_linear_graph(" ".join(o), lex, tying, topo, trans) for o in orths]
    for o, g in zip(orths, graphs):
        want = ralign.chain(model, o)
        got = (g.emission_ids, g.loop, g.fwd, g.skip, g.init, g.final)
        for a, b in zip(got, want):
            b = np.where(np.isinf(b), 1e30, b)
            assert np.allclose(a, b), o
    als = BatchAligner(s.scorer).align_scores(em_scores, graphs, nf)
    mix = spec.model(r.cfg).mixtures(r.cfg, d)
    M, K, D = mix.means.shape
    labels = np.full(tuple(feats.shape[:2]), -1, np.int32)
    for i, (o, a) in enumerate(zip(orths, als)):
        labels[i, : a.num_frames] = a.emission_ids
        g = ralign.chain(model, o)
        e = em_scores[i, : a.num_frames].double().numpy()
        ref, _ = ralign.best(*g, e)
        assert abs(a.score - ref) < 1e-2
        assert abs(ralign.path_cost(*g, e, a.state_indices) - ref) < 1e-2
    acc = em.accumulate(em.GmmAccumulator.zeros(M, K, D), mix, feats, labels)
    ref = ralign.statistics(feats.reshape(-1, D), torch.as_tensor(labels).reshape(-1),
                            d.acoustic, 1e-4)
    for got, want in zip((acc.count, acc.sum, acc.sumsq), ref):
        assert np.abs(got - want.numpy()).max() < 1e-4 * np.abs(want.numpy()).max()
