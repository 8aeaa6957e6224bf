"""PyTorch port vs JAX: word lattices from the decoder's records, and the
evaluator.

The port builds each utterance's lattice from its decode's own handle
(``decoder_lattice(handle, lemmas, b)``, the records copied to the host
once per handle); the reference from its decoder's last decode. From the
same tie-free emissions (the decoder tests' fixtures: every slice-B
option, the across-word network without deferred emission, and a
streamed decode) both give the same lattice: node times and final nodes
equal, the same arcs in the same order, am / lm scores and final scores
within 1e-4 relative (1e-3 absolute), as the decoder tests hold scores.
Each lattice holds its best path (oracle WER 0 against the decoded
words). The lattice image is the reference's byte for byte, and the
evaluator's edit distances, WER report and lattice oracle are the
reference's on seeded strings.
"""

import numpy as np
import pytest

from rasr_tpu.lattice import evaluator as jax_evaluator
from rasr_tpu.lattice.lattice import Lattice as JaxLattice
from rasr_tpu.lattice.lattice import LatticeArc as JaxLatticeArc
from rasr_tpu.lattice.lattice import decoder_lattice as jax_decoder_lattice
from rasr_tpu_torch.lattice import evaluator
from rasr_tpu_torch.lattice.lattice import Lattice, LatticeArc, decoder_lattice
from rasr_tpu_torch.search.streaming import StreamingDecoder
from tests.test_torch_decoder import (  # noqa: F401 (module-scoped fixtures)
    SLICE_B, _walk_case, slice_b_systems, slice_c_systems,
)

N = (14, 11, 9)
CASES = {
    **{f"slice-b:{k}": ("b", k, N, False) for k in sorted(SLICE_B)},
    "slice-b:n-frames-past-the-end": ("b", "root-select-deferred", (17, 14, 9), False),
    # the across-word network without deferred emission (its pre-emission
    # ties), under binding K, H, Kb and R
    "slice-c:across-word": ("c", "across-word", N, False),
    "slice-c:across-word-production": ("c", "across-word-production", N, False),
    # the port's lattice from a stream fed in blocks of 5, 5 and 4 frames
    "streamed:root-select-deferred": ("b", "root-select-deferred", N, True),
    "streamed:across-word": ("c", "across-word", N, True),
}


def _lattices(systems, kind, name, n, streamed):
    """(port lattices, JAX lattices, port results, the port's handle)."""
    jax_decoder, decoder, emis = _walk_case(systems, kind, name)
    jax_decoder.decode_scores(emis, np.array(n))
    want = [jax_decoder_lattice(jax_decoder, b) for b in range(3)]
    if streamed:
        sd = StreamingDecoder(decoder).restart(3, np.array(n))
        for lo in (0, 5, 10):
            sd.feed(emis[:, lo:lo + 5])
        handle = sd.finalize_device()
    else:
        handle = decoder.decode_scores_device(emis, np.array(n))
    got = [decoder_lattice(handle, decoder.tree.lemmas, b) for b in range(3)]
    return got, want, decoder.results_from_device(handle), handle


def _assert_lattice_equal(got, want):
    assert got.num_nodes == want.num_nodes
    np.testing.assert_array_equal(got.node_time, want.node_time)
    assert got.lemma_orths == want.lemma_orths
    assert sorted(got.final_scores) == sorted(want.final_scores)
    np.testing.assert_allclose([got.final_scores[k] for k in sorted(got.final_scores)],
                               [want.final_scores[k] for k in sorted(want.final_scores)],
                               rtol=1e-4, atol=1e-3)
    assert [(a.from_node, a.to_node, a.lemma) for a in got.arcs] == [
        (a.from_node, a.to_node, a.lemma) for a in want.arcs]
    np.testing.assert_allclose([(a.am_score, a.lm_score) for a in got.arcs],
                               [(a.am_score, a.lm_score) for a in want.arcs],
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lattice_matches_jax(slice_b_systems, slice_c_systems, case):
    kind, name, n, streamed = CASES[case]
    systems = slice_b_systems if kind == "b" else slice_c_systems
    got, want, results, handle = _lattices(systems, kind, name, n, streamed)
    assert any(lat.arcs for lat in want)
    for g, w in zip(got, want):
        _assert_lattice_equal(g, w)
    # one host copy of the records serves every utterance of the handle
    assert handle.records_to_host() is handle.records_to_host()
    # each lattice holds its decode's best path where that path is
    # complete and ends a word (the lattice's final nodes are those of
    # the complete hypotheses' last word ends)
    f = handle.finals
    complete = ((f.fstate < handle.num_final_states) & (f.fscore < 1e29)).any(dim=1)
    for lat, res, done in zip(got, results, complete.tolist()):
        if done and res.record_ids:
            assert evaluator.lattice_oracle(lat, res.words)[0] == 0, res.words


def test_lattice_image_is_the_reference_bytes(slice_b_systems):
    """The same lattice packs to the reference's bytes, and each package
    unpacks the other's image to the same lattice."""
    got, want, _, _ = _lattices(slice_b_systems, "b", "root-select-deferred", N, False)
    for lat in want:
        mine = Lattice(lat.num_nodes, [LatticeArc(a.from_node, a.to_node, a.lemma, a.am_score,
                                                  a.lm_score) for a in lat.arcs],
                       lat.node_time, dict(lat.final_scores), list(lat.lemma_orths))
        assert mine.pack() == lat.pack()
        assert Lattice.unpack(lat.pack()).pack() == lat.pack()
        assert JaxLattice.unpack(mine.pack()).pack() == mine.pack()
        assert mine.topological_order() == lat.topological_order()
    for lat in got:
        back = Lattice.unpack(lat.pack())
        _assert_lattice_equal(back, lat)
        assert JaxLattice.unpack(lat.pack()).pack() == lat.pack()


def _random_lattice(rng, cls, arc_cls, words):
    """A random DAG over ``words`` (nodes in time order, every arc forward,
    some epsilon and silence arcs) with two final nodes."""
    n = 8
    arcs = [arc_cls(0, 1, int(rng.integers(len(words))), 1.0, 0.5)]
    for s in range(n - 1):
        for _ in range(int(rng.integers(1, 4))):
            d = int(rng.integers(s + 1, n))
            arcs.append(arc_cls(s, d, int(rng.integers(-1, len(words))),
                                float(rng.uniform(0, 5)), float(rng.uniform(0, 2))))
    return cls(n, arcs, np.arange(n, dtype=np.int32) * 3, {n - 1: 0.0, n - 2: 1.0}, words)


def test_evaluator_matches_jax():
    """align_tokens, CorpusEvaluator and lattice_oracle on seeded strings
    and lattices: the reference's results."""
    rng = np.random.default_rng(11)
    words = ["A", "B", "C", "D", "[SILENCE]"]
    ours, theirs = evaluator.CorpusEvaluator(), jax_evaluator.CorpusEvaluator()
    for i in range(40):
        ref = list(rng.choice(words[:4], size=int(rng.integers(0, 7))))
        hyp = list(rng.choice(words[:4], size=int(rng.integers(0, 7))))
        s, ops = evaluator.align_tokens(ref, hyp)
        ws, wops = jax_evaluator.align_tokens(ref, hyp)
        assert ops == wops and s.report() == ws.report()
        assert ours.add(f"s{i}", " ".join(ref), " ".join(hyp)).report() == theirs.add(
            f"s{i}", " ".join(ref), " ".join(hyp)).report()
        lat = _random_lattice(np.random.default_rng(i), Lattice, LatticeArc, words)
        jlat = _random_lattice(np.random.default_rng(i), JaxLattice, JaxLatticeArc, words)
        assert evaluator.lattice_oracle(lat, ref) == jax_evaluator.lattice_oracle(jlat, ref)
    assert ours.report() == theirs.report() and ours.report()["ref_len"] > 0
    assert ours.segments == theirs.segments
