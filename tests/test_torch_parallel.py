"""PyTorch port vs JAX: the mesh and the sharded compute (``parallel/``).

Every case of ``tests/test_parallel.py``, plus the dry run. One gloo world
of 4 CPU ranks (``tests/torch_parallel_ranks.py``) runs every case over
``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` meshes; the JAX side runs the same
seeded numpy inputs on conftest's 8 virtual CPU devices. Each rank's
output is held to the JAX function's at the reference's tolerances: GMM
scores 1e-4, EM statistics 1e-4 / 1e-3 relative, fMLLR statistics 1e-4
relative + 1e-3, the tensor-parallel conformer 2e-4, counters and
shards exact, decodes word for word with scores within 1e-5 relative.
The work queue needs no world (explicit process ids).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rasr_tpu.corpus.audio import write_wav
from rasr_tpu.corpus.bliss import CorpusDescription as JaxCorpus
from rasr_tpu.models.gmm import MixtureSet as JaxMixtureSet
from rasr_tpu.models.gmm import make_scoring_tensors, mixture_scores
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.parallel import sharded as jsharded
from rasr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rasr_tpu.parallel.workqueue import CorpusWorkQueue as JaxQueue
from rasr_tpu.search.decoder import BeamConfig as JaxBeamConfig
from rasr_tpu.search.decoder import TreeDecoder as JaxTreeDecoder
from rasr_tpu.search.tree import build_prefix_tree as jax_build_prefix_tree
from rasr_tpu_torch import convert
from rasr_tpu_torch.corpus.bliss import CorpusDescription
from rasr_tpu_torch.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu_torch.models.gmm import MixtureSet
from rasr_tpu_torch.models.hmm import HmmTopology, TransitionModel
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.models.nn import ConformerEncoderNet
from rasr_tpu_torch.models.tying import MonophoneStateTying
from rasr_tpu_torch.parallel.workqueue import CorpusWorkQueue
from rasr_tpu_torch.search.decoder import BeamConfig
from rasr_tpu_torch.search.tree import build_prefix_tree
from rasr_tpu_torch.utils.archive import FileArchive
from tests.torch_parallel_ranks import run_world


def _mixtures(rng, M=6, K=2, D=8):
    """tests/test_parallel.py's draws, as (port, JAX) mixture sets."""
    arrays = dict(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 1.0 / K, np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    return MixtureSet(**arrays), JaxMixtureSet(**arrays)


def _decode_system():
    """tests/test_parallel.py::test_sharded_decode_batch's AB / BA system,
    built with the port's host modules (its lemmas reach the ranks)."""
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    lm = NgramLm.train_from_text([["AB", "BA"]], order=2)
    return lex, topo, tying, lm


CONFORMER = dict(num_classes=11, in_dim=6, d_model=16, num_blocks=2, num_heads=4, conv_kernel=7)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(12345)
    out = {}
    out["gmm"] = (_mixtures(rng, M=6, K=2, D=8), rng.normal(size=(8, 5, 8)).astype(np.float32))
    out["gmm-lse"] = (_mixtures(rng, M=8, K=3, D=4), rng.normal(size=(4, 3, 4)).astype(np.float32))
    ms = _mixtures(rng, M=4, K=2, D=5)
    feats = rng.normal(size=(160, 5)).astype(np.float32)
    labels = rng.integers(0, 4, size=160).astype(np.int32)
    labels[150:] = -1  # padding frames
    out["em"] = (ms, feats, labels)
    out["counters"] = np.arange(24, dtype=np.float64).reshape(8, 3)
    out["shard"] = rng.normal(size=(16, 4)).astype(np.float32)
    lex, topo, tying, lm = _decode_system()
    out["decode"] = (lex, topo, tying, lm,
                     rng.uniform(0, 6, size=(8, 6, tying.num_classes)).astype(np.float32))
    from rasr_tpu.models.nn import ConformerEncoderNet as JaxConformer

    jnet = JaxConformer(**{k: v for k, v in CONFORMER.items() if k != "in_dim"})
    x = rng.normal(size=(4, 10, 6)).astype(np.float32)
    lengths = np.array([10, 7, 5, 9], np.int32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), lengths=jnp.asarray(lengths))[
        "params"]
    want = np.asarray(jnet.apply({"params": params}, x, lengths=jnp.asarray(lengths)))
    net = ConformerEncoderNet(**CONFORMER, device="cpu")
    out["conformer"] = (convert.nn_params_from_flax(net, params), x, lengths, want)
    ms = _mixtures(rng)
    N = 333  # not a multiple of the data axis
    out["fmllr"] = (ms, rng.normal(size=(N, ms[0].dim)).astype(np.float32),
                    rng.integers(0, ms[0].num_mixtures, N))
    return out


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    (gm, _), gf = inputs["gmm"]
    (lm_, _), lf = inputs["gmm-lse"]
    (em, _), ef, el = inputs["em"]
    lex, topo, tying, lm, emis = inputs["decode"]
    state, x, lengths, _ = inputs["conformer"]
    (fm, _), ff, fmix = inputs["fmllr"]
    tree = build_prefix_tree(lex, tying, topo, TransitionModel(), lm_vocab=lm.vocab)
    cases = [
        ("mesh-shapes", "mesh_shapes", (2, 2), {}),
        ("gmm", "sharded_gmm", (1, 4), dict(mixtures=gm, feats=gf, scale=0.7)),
        ("gmm-lse", "sharded_gmm", (2, 2), dict(mixtures=lm_, feats=lf, max_approx=False)),
        ("em", "dp_accumulate", (4, 1), dict(mixtures=em, feats=ef, labels=el)),
        ("counters", "psum_counters", (4, 1), dict(values=inputs["counters"])),
        ("shard", "shard_batch", (4, 1), dict(x=inputs["shard"])),
        ("decode", "dp_decode", (4, 1), dict(
            tree=tree, lm=compile_ngram(lm), cfg=BeamConfig(max_hyps=32, word_end_limit=8),
            emis=emis, n=np.full(8, 6, np.int32))),
        ("conformer", "conformer_tp", (2, 2), dict(net_kw=CONFORMER, state=state, x=x,
                                                   lengths=lengths)),
        ("fmllr", "dp_fmllr", (4, 1), dict(mixtures=fm, feats=ff, mix=fmix)),
        ("dryrun", "dryrun", (4, 1), dict(n=4)),
    ]
    return run_world(tmp_path_factory.mktemp("parallel-world"), cases)


def test_mesh_shapes(world):
    coords = set()
    for out in world["mesh-shapes"]:
        np.testing.assert_array_equal(out["shape"], [2, 2])
        np.testing.assert_array_equal(out["auto"], [4, 1])  # make_mesh(model=1)
        coords.add((int(out["data"]), int(out["model"])))
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


def _assert_shards(outs, want, rtol, atol):
    """Each rank's rows == the reference's; the data ranks cover the batch."""
    for out in outs:
        lo, hi = out["rows"]
        np.testing.assert_allclose(out["scores"], want[lo:hi], rtol=rtol, atol=atol)
    assert {r for o in outs for r in range(*o["rows"])} == set(range(len(want)))


def test_sharded_gmm_matches_single(world, inputs):
    """The mixtures over a 4-way model axis (6 mixtures pad to 8, the last
    block's densities at c = 1e30) through the GMM kernel's plain version
    == the JAX sharded scorer and the single-device one."""
    (_, jms), feats = inputs["gmm"]
    want = np.asarray(jsharded.ShardedGmmScorer(jms, jax_make_mesh(data=4, model=2), scale=0.7)(
        feats))
    from rasr_tpu.models.scorer import GmmFeatureScorer as JaxScorer

    np.testing.assert_allclose(want, np.asarray(JaxScorer(jms, scale=0.7)(feats)), rtol=1e-4,
                               atol=1e-4)
    _assert_shards(world["gmm"], want, 1e-4, 1e-4)


def test_sharded_gmm_logsumexp_mode(world, inputs):
    (_, jms), feats = inputs["gmm-lse"]
    want = np.asarray(mixture_scores(jnp.asarray(feats), make_scoring_tensors(jms),
                                     max_approx=False))
    np.testing.assert_allclose(
        np.asarray(jsharded.ShardedGmmScorer(jms, jax_make_mesh(data=2, model=4),
                                             max_approx=False)(feats)), want, rtol=1e-4, atol=1e-4)
    _assert_shards(world["gmm-lse"], want, 1e-4, 1e-4)


def test_dp_accumulate_matches_local(world, inputs):
    """Statistics summed over the data axis == the JAX DP statistics and
    the single-process accumulation (the combine-accumulators rule)."""
    (_, jms), feats, labels = inputs["em"]
    from rasr_tpu.train.em import GmmAccumulator, accumulate

    acc = GmmAccumulator.zeros(4, 2, 5)
    accumulate(acc, jms, feats, labels)
    jcount, js1, js2 = jsharded.dp_accumulate(jax_make_mesh(data=8, model=1), jms, feats, labels)
    for out in world["em"]:
        for got, dp, local, rtol in ((out["count"], jcount, acc.count, 1e-4),
                                     (out["sum"], js1, acc.sum, 1e-3),
                                     (out["sumsq"], js2, acc.sumsq, 1e-3)):
            np.testing.assert_allclose(got, dp, rtol=rtol, atol=1e-4)
            np.testing.assert_allclose(got, local, rtol=rtol, atol=1e-4)


def test_psum_counters(world, inputs):
    vals = inputs["counters"]
    want = jsharded.psum_counters(jax_make_mesh(data=8, model=1), vals)
    for out in world["counters"]:
        np.testing.assert_allclose(out["total"], want)
        np.testing.assert_allclose(out["total"], vals.sum(0))


def test_shard_batch_placement(world, inputs):
    x = inputs["shard"]
    for r, out in enumerate(world["shard"]):
        np.testing.assert_array_equal(out["local"], x[4 * r: 4 * r + 4])
        assert str(out["device"]) == "cpu"
        assert str(out["placements"]) == "(Shard(dim=0), Replicate())"


def test_sharded_decode_batch(world, inputs):
    """dp_decode: 8 utterances over 4 data ranks == the JAX dp_decode over
    8 devices, word for word, on every rank."""
    from rasr_tpu.corpus.lexicon import Lexicon as JaxLexicon
    from rasr_tpu.corpus.lexicon import build_default_silence as jax_silence
    from rasr_tpu.models.hmm import HmmTopology as JaxTopology
    from rasr_tpu.models.hmm import TransitionModel as JaxTrans
    from rasr_tpu.models.tying import MonophoneStateTying as JaxTying

    lex = JaxLexicon()
    jax_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = JaxTopology(states_per_phone=1, silence_states=1)
    lm = inputs["decode"][3]
    tree = jax_build_prefix_tree(lex, JaxTying(lex, topo), topo, JaxTrans(), lm_vocab=lm.vocab)
    dec = JaxTreeDecoder(tree, jax_compile_ngram(lm), JaxBeamConfig(max_hyps=32, word_end_limit=8))
    emis = inputs["decode"][4]
    want = jsharded.dp_decode(dec, jax_make_mesh(data=8, model=1), emis, np.full(8, 6, np.int32))
    for out in world["decode"]:
        assert list(out["orth"]) == [r.orth for r in want]
        np.testing.assert_allclose(out["score"], [r.score for r in want], rtol=1e-5)


def test_workqueue_partition_and_resume(tmp_path):
    """Explicit process ids partition the corpus as the JAX queue does;
    a run that finishes part of its slice resumes where it stopped."""
    xml = ['<corpus name="t">']
    for i in range(10):
        wav = tmp_path / f"r{i}.wav"
        write_wav(str(wav), np.zeros(1600, np.float32), 16000)
        xml.append(f'<recording name="r{i}" audio="{wav}">'
                   f'<segment name="s" start="0" end="0.1"><orth>X</orth></segment></recording>')
    xml.append("</corpus>")
    (tmp_path / "c.xml").write_text("".join(xml))
    corpus = CorpusDescription.load(str(tmp_path / "c.xml"))
    jcorpus = JaxCorpus.load(str(tmp_path / "c.xml"))
    done = str(tmp_path / "done.cache")
    q0, q1 = (CorpusWorkQueue(corpus, i, 2, done) for i in range(2))
    names0 = {s.full_name for s in q0.segments()}
    names1 = {s.full_name for s in q1.segments()}
    assert not (names0 & names1) and len(names0 | names1) == 10
    for i, names in enumerate((names0, names1)):
        assert names == {s.full_name for s in JaxQueue(jcorpus, i, 2).segments()}
    assert CorpusWorkQueue(corpus).process_count == 1  # no process group: one process

    def make_fn(limit):
        def fn(batch):
            finished = []
            with FileArchive(done, "a") as ar:
                for seg in batch[:limit]:
                    ar.write(seg.full_name, b"ok")
                    finished.append(seg.full_name)
            return finished
        return fn

    rep1 = q0.run(make_fn(1), batch_size=2)  # finishes 1 per batch of 2
    assert rep1.processed >= 1
    rep2 = q0.run(make_fn(10), batch_size=10)
    assert rep2.skipped == rep1.processed
    assert not q0.pending()


def test_conformer_tp_matches_replicated(world, inputs):
    """parallelize_module over a 2-way model axis (heads, FF and conv
    columns in and rows out, the depthwise channels) == flax's replicated
    apply on the same parameters, each data rank on its utterances."""
    _, _, _, want = inputs["conformer"]
    for out in world["conformer"]:
        lo, hi = out["rows"]
        np.testing.assert_allclose(out["out"], want[lo:hi], rtol=2e-4, atol=2e-4)
        specs = dict(out["specs"].tolist())
        assert specs["block.0.ff1_in.weight"] == "Shard(dim=0)"
        assert specs["block.0.ff1_out.weight"] == "Shard(dim=1)"
        assert specs["block.0.mhsa.query.weight"] == "Shard(dim=0)"
        assert specs["block.0.mhsa.out.weight"] == "Shard(dim=1)"
        assert specs["block.0.conv_dw.weight"] == "Shard(dim=0)"
        assert specs["block.0.ff1_ln.weight"] == "Replicate()"
        assert str(out["query_placement"]) == "(Shard(dim=0),)"
        np.testing.assert_array_equal(out["query_local"], [8, 16])  # 2 of 4 heads


def test_dp_fmllr_stats_matches_local(world, inputs):
    """Adaptation statistics over the data axis == the JAX DP statistics
    and the single-device ones (333 frames over 4 ranks)."""
    from rasr_tpu.train.fmllr import fmllr_stats

    (_, jms), feats, mix = inputs["fmllr"]
    G0, k0, b0 = fmllr_stats(feats, mix, jms)
    G1, k1, b1 = jsharded.dp_fmllr_stats(jax_make_mesh(data=8), jms, feats, mix)
    for out in world["fmllr"]:
        assert float(out["beta"]) == b0 == b1 == len(mix)
        np.testing.assert_allclose(out["G"], G0, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(out["k"], k0, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(out["G"], G1, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(out["k"], k1, rtol=1e-4, atol=1e-3)


def test_dryrun_multichip(world):
    """The dry run on a (2, 2) mesh of 4 ranks: the sharded step equals the
    unsharded one on every rank (checked inside), all 48 frames counted,
    the same statistics everywhere."""
    outs = world["dryrun"]
    for out in outs:
        np.testing.assert_array_equal(out["mesh"], [2, 2])
        assert out["count"].sum() == 4 * 12
        np.testing.assert_array_equal(out["means"], outs[0]["means"])
        assert np.isfinite(out["variances"]).all()
