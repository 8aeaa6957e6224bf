"""PyTorch port vs JAX: the corpus pipeline around the decoder.

On the reference's toy corpus (``tests/test_pipeline.py``: five sine-tone
recordings of 0.4-1.2 s, here with orths from the lexicon): the visitor's
batches and partitions and the prefetching visitor equal the reference's;
cache archives written by one package read back in the other; and the
port's ``OfflineRecognizer`` gives the JAX recognizer's words, scores,
WER report, CTM lines and archived lattices, with prefetch on and off, and
from a feature cache, and with per-speaker feature transforms (fMLLR). The
recognizer's unported branches raise.
"""

import numpy as np
import pytest

from rasr_tpu.corpus.audio import write_wav as jax_write_wav
from rasr_tpu.corpus.bliss import CorpusDescription as JaxCorpus
from rasr_tpu.lattice.lattice import Lattice as JaxLattice
from rasr_tpu.models.gmm import MixtureSet as JaxMixtureSet
from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.models.scorer import GmmFeatureScorer as JaxGmmScorer
from rasr_tpu.ops.frontend import FeatureFrontend as JaxFrontend
from rasr_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from rasr_tpu.pipeline.feature_extractor import FeatureExtractor as JaxFeatureExtractor
from rasr_tpu.pipeline.feature_extractor import load_features as jax_load_features
from rasr_tpu.pipeline.recognizer import OfflineRecognizer as JaxRecognizer
from rasr_tpu.pipeline.visitor import CorpusVisitor as JaxVisitor
from rasr_tpu.search import decoder as jdec
from rasr_tpu.train.fmllr import apply_speaker_transforms as jax_apply_speaker_transforms
from rasr_tpu.utils import archive as jax_archive
from rasr_tpu_torch.corpus.bliss import CorpusDescription
from rasr_tpu_torch.lattice.lattice import Lattice
from rasr_tpu_torch.models.gmm import MixtureSet
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.models.scorer import GmmFeatureScorer
from rasr_tpu_torch.ops.frontend import FeatureFrontend, FrontendConfig
from rasr_tpu_torch.pipeline.feature_extractor import FeatureExtractor, load_features
from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
from rasr_tpu_torch.pipeline.visitor import CorpusVisitor, prefetch_batches
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu_torch.utils import archive
from tests.test_torch_decoder import slice_b_systems  # noqa: F401 (module-scoped fixture)

ORTHS = ["AB", "BA CA", "AA ABC", "CA", "BAC AB"]
#: K, H, Kb and R bind on the toy corpus's 40-120 frames
BEAM = dict(max_hyps=16, word_end_limit=4, root_hyps=3, branch_hyps=4, lm_scale=0.7)
NUM_FEATS = 16  # FrontendConfig's cepstra


def _toy_corpus(tmp_path):
    """tests/test_pipeline.py's toy corpus: recording i is a (400 + 100 i)
    Hz tone of 0.4 + 0.2 i s; the orths are the lexicon's words."""
    sr = 16000
    xml = ['<corpus name="toy">']
    for i in range(5):
        dur = 0.4 + 0.2 * i
        wav = tmp_path / f"rec{i}.wav"
        t = np.arange(int(dur * sr)) / sr
        jax_write_wav(str(wav), (0.2 * np.sin(2 * np.pi * (400 + 100 * i) * t))
                      .astype(np.float32), sr)
        xml.append(
            f'<recording name="rec{i}" audio="{wav}">'
            f'<segment name="s" start="0" end="{dur}"><orth>{ORTHS[i]}</orth></segment>'
            f"</recording>"
        )
    xml.append("</corpus>")
    path = tmp_path / "toy.corpus"
    path.write_text("".join(xml))
    return str(path)


@pytest.fixture(scope="module")
def toy(tmp_path_factory, slice_b_systems):
    """The corpus, and the tie-free slice-B network (hashed tying, a
    triphone-unique lexicon) with random single-density GMMs over its
    classes, in both packages."""
    tmp = tmp_path_factory.mktemp("toy")
    tying, lm, jtree, ttree, _ = slice_b_systems[True]
    rng = np.random.default_rng(7)
    means = rng.normal(size=(tying.num_classes, NUM_FEATS)).astype(np.float32)
    variances = (0.5 + rng.uniform(size=means.shape)).astype(np.float32)
    return dict(path=_toy_corpus(tmp), tmp=tmp, lm=lm, jtree=jtree, ttree=ttree,
                jms=JaxMixtureSet.single_density(means, variances),
                ms=MixtureSet.single_density(means, variances))


def _jax_recognizer(toy, **kw):
    dec = jdec.TreeDecoder(toy["jtree"], jax_compile_ngram(toy["lm"]), jdec.BeamConfig(**BEAM))
    return JaxRecognizer(JaxFrontend(JaxFrontendConfig()), JaxGmmScorer(toy["jms"]), dec, **kw)


def _recognizer(toy, **kw):
    dec = TreeDecoder(toy["ttree"], compile_ngram(toy["lm"]), BeamConfig(**BEAM), device="cpu")
    return OfflineRecognizer(FeatureFrontend(FrontendConfig(), device="cpu"),
                             GmmFeatureScorer(toy["ms"], device="cpu"), dec, **kw)


def _lattice_data(lat):
    return (lat.num_nodes, lat.node_time.tolist(), lat.final_scores, lat.lemma_orths,
            [(a.from_node, a.to_node, a.lemma, a.am_score, a.lm_score) for a in lat.arcs])


def _run(make, toy, tag, visitor, **kw):
    """Run a recognizer with a lattice archive and a CTM file: results,
    WER report, per-segment evaluations, CTM text and each archived
    lattice as plain data."""
    lat_path, ctm_path = toy["tmp"] / f"{tag}.lat", toy["tmp"] / f"{tag}.ctm"
    for p in (lat_path, ctm_path):
        if p.exists():
            p.unlink()
    rec = make(toy, lattice_archive=str(lat_path), ctm_file=str(ctm_path), **kw)
    results = rec.run(visitor)
    with jax_archive.FileArchive(str(lat_path), "r") as ar:
        lats = {k: _lattice_data(JaxLattice.unpack(ar.read(k))) for k in ar.keys()}
    return dict(results=results, report=rec.evaluator.report(), segments=rec.evaluator.segments,
                ctm=ctm_path.read_text(), lattices=lats)


@pytest.fixture(scope="module")
def jax_run(toy):
    return _run(_jax_recognizer, toy, "jax", JaxVisitor(JaxCorpus.load(toy["path"]), batch_size=2))


def _assert_runs_equal(got, want):
    assert [r.segment_name for r in got["results"]] == [r.segment_name for r in want["results"]]
    for a, b in zip(got["results"], want["results"]):
        assert a.words == b.words and a.word_ends == b.word_ends
        assert a.record_ids == b.record_ids
        np.testing.assert_allclose(a.score, b.score, rtol=1e-4)
    assert any(r.words for r in got["results"])
    assert got["report"] == want["report"] and got["report"]["ref_len"] == 8
    assert [{k: v for k, v in s.items()} for s in got["segments"]] == want["segments"]
    assert got["ctm"] == want["ctm"] and got["ctm"]
    assert sorted(got["lattices"]) == sorted(want["lattices"]) and len(got["lattices"]) == 5
    for name, (n, times, finals, orths, arcs) in got["lattices"].items():
        wn, wtimes, wfinals, worths, warcs = want["lattices"][name]
        assert (n, times, orths) == (wn, wtimes, worths)
        assert sorted(finals) == sorted(wfinals)
        np.testing.assert_allclose([finals[k] for k in sorted(finals)],
                                   [wfinals[k] for k in sorted(wfinals)], rtol=1e-4, atol=1e-3)
        assert [a[:3] for a in arcs] == [a[:3] for a in warcs]
        np.testing.assert_allclose(np.array([a[3:] for a in arcs]).reshape(-1, 2),
                                   np.array([a[3:] for a in warcs]).reshape(-1, 2),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("prefetch", [True, False])
def test_recognizer_matches_jax(toy, jax_run, prefetch):
    visitor = CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2)
    got = _run(_recognizer, toy, f"port-{prefetch}", visitor, prefetch=prefetch)
    _assert_runs_equal(got, jax_run)


def test_recognizer_from_feature_cache_matches_jax(toy):
    """Both recognizers decode the features the port's extractor cached
    (metadata-only batches); the reference reads the port's cache."""
    cache = str(toy["tmp"] / "feats.cache")
    fe = FeatureFrontend(FrontendConfig(), device="cpu")
    assert FeatureExtractor(fe, cache).run(
        CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2)) == 5
    assert FeatureExtractor(fe, cache).run(
        CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2)) == 0  # idempotent
    for seg in CorpusDescription.load(toy["path"]).segments():
        np.testing.assert_array_equal(jax_load_features(cache, seg.full_name),
                                      load_features(cache, seg.full_name))
    want = _run(_jax_recognizer, toy, "jax-cache",
                JaxVisitor(JaxCorpus.load(toy["path"]), batch_size=2, load_audio=False),
                feature_cache=cache)
    got = _run(_recognizer, toy, "port-cache",
               CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2,
                             load_audio=False), feature_cache=cache)
    _assert_runs_equal(got, want)


def test_feature_extractor_matches_jax(toy):
    """Each package's extractor caches its frontend's features of each
    segment (its first n_frames rows); the reference's cache reads the
    same in the port, and both caches hold the same segments and frames.
    (The frontends themselves are held together in
    ``tests/test_torch_frontend.py``.)"""
    caches = {k: str(toy["tmp"] / f"{k}.feats") for k in ("jax", "port")}
    JaxFeatureExtractor(JaxFrontend(JaxFrontendConfig()), caches["jax"]).run(
        JaxVisitor(JaxCorpus.load(toy["path"]), batch_size=2))
    fe = FeatureFrontend(FrontendConfig(), device="cpu")
    visitor = CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2)
    FeatureExtractor(fe, caches["port"]).run(visitor)
    for batch in visitor.batches():
        feats, n = fe(batch.samples, batch.lengths)
        for i, name in enumerate(batch.names):
            want = jax_load_features(caches["jax"], name)
            np.testing.assert_array_equal(load_features(caches["jax"], name), want)
            got = load_features(caches["port"], name)
            assert got.shape == want.shape == (int(n[i]), NUM_FEATS)
            np.testing.assert_array_equal(got, feats[i, : int(n[i])].numpy())


def _visitor_data(batches):
    return [(b.names, b.orths, b.samples.tolist(), b.lengths.tolist()) for b in batches]


@pytest.mark.parametrize("partition", [(0, 1), (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("load_audio", [True, False])
def test_visitor_batches_match_jax(toy, partition, load_audio):
    kw = dict(batch_size=2, partition=partition[0], num_partitions=partition[1],
              load_audio=load_audio)
    want = _visitor_data(JaxVisitor(JaxCorpus.load(toy["path"]), **kw).batches())
    got = _visitor_data(CorpusVisitor(CorpusDescription.load(toy["path"]), **kw).batches())
    assert got == want and want


def test_prefetch_equals_plain_batching(toy):
    """The prefetching visitor yields the plain batches; a worker's error
    re-raises in the consumer; an abandoned generator stops its thread."""
    corpus = CorpusDescription.load(toy["path"])
    plain = _visitor_data(CorpusVisitor(corpus, 2).batches())
    assert _visitor_data(prefetch_batches(CorpusVisitor(corpus, 2))) == plain

    class Boom(CorpusVisitor):
        def batches(self):
            yield from list(CorpusVisitor(corpus, 2).batches())[:1]
            raise RuntimeError("io exploded")

    it = prefetch_batches(Boom(corpus, 2))
    next(it)
    with pytest.raises(RuntimeError, match="io exploded"):
        list(it)
    import threading
    import time

    before = threading.active_count()
    it2 = prefetch_batches(CorpusVisitor(corpus, 1), depth=1)
    next(it2)
    it2.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_archives_interoperate(tmp_path, writer):
    """An archive (entries, an overwrite, a tombstone, ndarray and lattice
    images) written by one package reads back the same in the other."""
    w, r = (archive, jax_archive) if writer == "port" else (jax_archive, archive)
    LatW, LatR = (Lattice, JaxLattice) if writer == "port" else (JaxLattice, Lattice)
    rng = np.random.default_rng(3)
    arr = rng.normal(size=(7, 5)).astype(np.float32)
    lat = LatW(num_nodes=3, arcs=[], node_time=np.array([0, 4, 9], np.int32),
               final_scores={2: 1.5}, lemma_orths=["A", "B"])
    path = str(tmp_path / "a.cache")
    with w.FileArchive(path, "w") as ar:
        ar.write("x", b"first")
        ar.write("x", b"second" * 100)
        ar.write("gone", b"...")
        ar.delete("gone")
        ar.write("arr", w.pack_ndarray(arr))
        ar.write("lat", lat.pack())
    with r.FileArchive(path, "r") as ar:
        assert sorted(ar.keys()) == ["arr", "lat", "x"]
        assert ar.read("x") == b"second" * 100
        np.testing.assert_array_equal(r.unpack_ndarray(ar.read("arr")), arr)
        back = LatR.unpack(ar.read("lat"))
        assert back.pack() == lat.pack()
    (tmp_path / "a.cache.idx").unlink()  # stale index: rescan
    with r.FileArchive(path, "a") as ar:
        assert "gone" not in ar and ar.read("x") == b"second" * 100


def test_unported_recognizer_branches_raise(toy, jax_run, tmp_path):
    """The sharded decode (``mesh``), which raised before it was ported,
    over a one-rank gloo world's (1, 1) mesh: the data-parallel path
    (features, scores and the decode of the rank's share, the assembled
    handle, rank 0's archive and CTM) equals the JAX recognizer's run.
    The multi-rank runs: tests/test_torch_parallel_decode.py and the card's
    ``parallel`` phase."""
    import torch.distributed as dist

    from rasr_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed("gloo", "file://" + str(tmp_path / "store"), 0, 1)
    try:
        visitor = CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2)
        got = _run(_recognizer, toy, "port-mesh", visitor, mesh=make_mesh(1, 1, device="cpu"))
    finally:
        dist.destroy_process_group()
    _assert_runs_equal(got, jax_run)


def _nbest_lines(path):
    """(segment, rank, score, words) of each line of an n-best file."""
    out = []
    for line in path.read_text().splitlines():
        seg, rank, score, *words = line.split(" ")
        out.append((seg, int(rank), float(score), " ".join(words)))
    return out


def test_recognizer_nbest_matches_jax(toy):
    """The n-best file (``flf.n_best`` of each decode lattice) == the JAX
    recognizer's on the toy corpus: the same segments, ranks and words,
    scores within 1e-4 relative as the decodes' (costs of 1e3 carry the
    frontend's float32 sums beyond the printed 4th decimal); rank 0 is the
    best path's words."""
    paths = {k: toy["tmp"] / f"{k}.nbest" for k in ("jax", "port")}
    _jax_recognizer(toy, nbest_file=str(paths["jax"]), nbest=4).run(
        JaxVisitor(JaxCorpus.load(toy["path"]), batch_size=2))
    results = _recognizer(toy, nbest_file=str(paths["port"]), nbest=4).run(
        CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2))
    got, want = _nbest_lines(paths["port"]), _nbest_lines(paths["jax"])
    assert [(s, r, w) for s, r, _, w in got] == [(s, r, w) for s, r, _, w in want]
    np.testing.assert_allclose([x[2] for x in got], [x[2] for x in want], rtol=1e-4)
    assert any(r > 0 for _, r, _, _ in got)
    best = {res.segment_name: " ".join(res.words) for res in results}
    assert {s: w for s, r, _, w in got if r == 0} == best


def _transforms(seed=11):
    """A per-speaker fMLLR table: a near-identity affine W [16, 17] as the
    default ("*"), which every toy segment (no speaker) takes."""
    rng = np.random.default_rng(seed)
    W = np.hstack([np.eye(NUM_FEATS) + 0.05 * rng.normal(size=(NUM_FEATS, NUM_FEATS)),
                   0.1 * rng.normal(size=(NUM_FEATS, 1))])
    return {"*": W}


def test_recognizer_with_speaker_transforms_matches_jax(toy):
    """Features through each segment's transform (the port: one batched
    [B, D, D] product on the decoder's device) decode as the JAX
    recognizer's do."""
    table = _transforms()
    want = _run(_jax_recognizer, toy, "jax-fmllr",
                JaxVisitor(JaxCorpus.load(toy["path"]), batch_size=2), feature_transforms=table)
    got = _run(_recognizer, toy, "port-fmllr",
               CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2),
               feature_transforms=table)
    _assert_runs_equal(got, want)


def test_identity_transforms_equal_no_transforms(toy, jax_run):
    eye = {"*": np.hstack([np.eye(NUM_FEATS), np.zeros((NUM_FEATS, 1))])}
    visitor = CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2)
    got = _run(_recognizer, toy, "port-eye", visitor, feature_transforms=eye)
    plain = _run(_recognizer, toy, "port-plain", visitor)
    assert [(r.words, r.score) for r in got["results"]] == [
        (r.words, r.score) for r in plain["results"]]
    assert got["lattices"] == plain["lattices"] and got["ctm"] == plain["ctm"]
    _assert_runs_equal(got, jax_run)


def test_feature_extractor_with_speaker_transforms_matches_jax(toy):
    """Cached features through the speaker transforms: the port's batched
    product on the frontend's device == the reference's host (float64)
    ``apply_speaker_transforms`` of the same frontend's features, within
    1e-5 (float32 sums); the reference's extractor caches the same
    segments and frames."""
    table = _transforms(12)
    caches = {k: str(toy["tmp"] / f"{k}-fmllr.feats") for k in ("jax", "port")}
    JaxFeatureExtractor(JaxFrontend(JaxFrontendConfig()), caches["jax"],
                        feature_transforms=table).run(
        JaxVisitor(JaxCorpus.load(toy["path"]), batch_size=2))
    fe = FeatureFrontend(FrontendConfig(), device="cpu")
    visitor = CorpusVisitor(CorpusDescription.load(toy["path"]), batch_size=2)
    FeatureExtractor(fe, caches["port"], feature_transforms=table).run(visitor)
    for batch in visitor.batches():
        feats, n = fe(batch.samples, batch.lengths)
        want = jax_apply_speaker_transforms(feats.numpy(), batch.segments, table)
        for i, name in enumerate(batch.names):
            got = load_features(caches["port"], name)
            assert got.shape == load_features(caches["jax"], name).shape
            np.testing.assert_allclose(got, want[i, : int(n[i])], rtol=1e-5, atol=1e-5)
