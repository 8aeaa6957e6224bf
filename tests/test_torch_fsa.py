"""PyTorch port vs JAX: the FSA library, the grammar LM and the lattice's
FSA bridge (``fsa/``, ``models/lm/grammar.py``, ``lattice/lattice.py``).

The port keeps its own copies of the host modules ``fsa/automaton.py``,
``fsa/algorithms.py``, ``models/lm/grammar.py`` and ``search/wfst.py``,
byte-identical to the reference's (their imports are package-relative).
Every case of ``tests/test_fsa.py`` runs once more with the port's
modules in the place of the reference's; the grammar cases of
``tests/test_lm_variants.py`` and the lattice <-> FSA round trip of
``tests/test_lattice.py`` run on both packages and compare what comes
back (exactly: the same host arithmetic in float64).
"""

import inspect
import math
import os
import sys

import numpy as np
import pytest

import tests.test_fsa as fsa_cases
from rasr_tpu.fsa import algorithms as jalgo
from rasr_tpu.fsa import automaton as jauto
from rasr_tpu.lattice import flf as jflf
from rasr_tpu.lattice import lattice as jlat
from rasr_tpu.models.lm.grammar import FsaGrammarLm as JaxGrammarLm
from rasr_tpu_torch.fsa import algorithms as talgo
from rasr_tpu_torch.fsa import automaton as tauto
from rasr_tpu_torch.lattice import flf as tflf
from rasr_tpu_torch.lattice import lattice as tlat
from rasr_tpu_torch.models.lm.grammar import FsaGrammarLm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ("fsa/automaton.py", "fsa/algorithms.py", "models/lm/grammar.py", "search/wfst.py")


@pytest.mark.parametrize("path", COPIES)
def test_host_copies_are_byte_identical(path):
    with open(os.path.join(ROOT, "rasr_tpu", path), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "rasr_tpu_torch", path), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("name", sorted(n for n in dir(fsa_cases) if n.startswith("test_")))
def test_fsa_case_on_the_port(name, monkeypatch, tmp_path):
    """``tests/test_fsa.py::<name>`` with every name it takes from the
    reference's ``fsa`` modules bound to the port's (also the imports
    inside the test functions, through ``sys.modules``)."""
    monkeypatch.setitem(sys.modules, "rasr_tpu.fsa.automaton", tauto)
    monkeypatch.setitem(sys.modules, "rasr_tpu.fsa.algorithms", talgo)
    swapped = 0
    for key, value in list(vars(fsa_cases).items()):
        for jmod, tmod in ((jauto, tauto), (jalgo, talgo)):
            if getattr(jmod, key, None) is value and value is not None:
                monkeypatch.setattr(fsa_cases, key, getattr(tmod, key))
                swapped += 1
    assert swapped >= 15 and fsa_cases.Automaton is tauto.Automaton
    fn = getattr(fsa_cases, name)
    fn(**{p: tmp_path for p in inspect.signature(fn).parameters})


def _grammar_trace(cls):
    """What the grammar cases of ``tests/test_lm_variants.py`` read back."""
    lm = cls.from_sequences([["call", "home"], ["call", "work"], ["hang", "up"]],
                            costs=[0.0, 1.0, 0.5])
    h = lm.start_history()
    v = lm.vocab
    h2 = lm.extended_history(h, v["call"])
    h3 = lm.extended_history(h2, v["home"])
    costs = cls.from_sequences([["a"], ["b"]], costs=[0.25, 2.0])
    seq = cls.from_sequences([["x", "y"]])
    return dict(
        vocab=v, h=h, h2=h2, h3=h3,
        scores=[lm.score(h, v["call"]), lm.score(h2, v["home"]), lm.score(h2, v["up"]),
                lm.score(h, v["hang"]), lm.score(lm.extended_history(h, v["hang"]), v["up"])],
        ends=[lm.sentence_end_score(h3), lm.sentence_end_score(h2)],
        rejected=lm.extended_history(h2, v["up"]),
        costs=[costs.score(costs.start_history(), costs.vocab[w]) for w in "ab"],
        sequences=[seq.sequence_score(["x", "y"]), seq.sequence_score(["y", "x"])],
    )


def test_grammar_lm_matches_jax():
    """Accept and reject, arc costs, the sequence API: port == JAX, and
    the reference's own expectations on the port."""
    got, want = _grammar_trace(FsaGrammarLm), _grammar_trace(JaxGrammarLm)
    assert got == want
    assert got["scores"][:2] == [0.0, 0.0] and got["scores"][2] >= 1e8
    assert got["ends"][0] == 0.0 and got["ends"][1] >= 1e8
    assert got["rejected"] == ()
    np.testing.assert_allclose(got["costs"], [0.25, 2.0])
    assert got["sequences"][0] == 0.0 and got["sequences"][1] >= 1e8


def _diamond(mod):
    """0 -> {A(1) | B(2)} -> 1 -> C(0.5) -> 2(final)."""
    arcs = [mod.LatticeArc(0, 1, 0, 1.0, 0.0), mod.LatticeArc(0, 1, 1, 2.0, 0.0),
            mod.LatticeArc(1, 2, 2, 0.5, 0.0)]
    return mod.Lattice(num_nodes=3, arcs=arcs, node_time=np.array([0, 5, 10], np.int32),
                       final_scores={2: 0.0}, lemma_orths=["A", "B", "C"])


def _bridge_trace(lat_mod, flf_mod, algo):
    """``tests/test_lattice.py::test_lattice_fsa_bridge_roundtrip``'s
    steps, returning what they read back."""
    import dataclasses as dc

    lat = _diamond(lat_mod)
    fsa = lat_mod.lattice_to_fsa(lat)
    cost, arcs = algo.best(fsa)
    score, path = flf_mod.best_path(lat)
    lat2 = lat_mod.fsa_to_lattice(fsa)
    score2, path2 = flf_mod.best_path(lat2)
    worse = dc.replace(lat, arcs=[lat_mod.LatticeArc(a.from_node, a.to_node, a.lemma,
                                                     a.am_score + 5.0, a.lm_score)
                                  for a in lat.arcs])
    cost_u, _ = algo.best(algo.union(lat_mod.lattice_to_fsa(lat), lat_mod.lattice_to_fsa(worse)))
    return dict(
        cost=cost, score=score, score2=score2, cost_u=cost_u,
        labels=[fsa.input_symbols[a.ilabel] for a in arcs if a.ilabel != 0],
        words=[lat.lemma_orths[a.lemma] for a in path],
        words2=[lat2.lemma_orths[a.lemma] for a in path2 if a.lemma >= 0],
        fsa_arcs=[[(a.ilabel, a.olabel, a.target, a.weight) for a in out] for out in fsa.arcs],
        finals=dict(fsa.finals),
        lat2=(lat2.num_nodes, [(a.from_node, a.to_node, a.lemma, a.am_score, a.lm_score)
                               for a in lat2.arcs], lat2.final_scores, lat2.lemma_orths),
    )


def test_lattice_fsa_bridge_roundtrip():
    """lattice -> fsa best path == flf best path; back to a lattice; union
    via fsa ops: port == JAX, and the reference's expectations."""
    got = _bridge_trace(tlat, tflf, talgo)
    assert got == _bridge_trace(jlat, jflf, jalgo)
    assert math.isclose(got["cost"], got["score"], rel_tol=1e-9)
    assert got["labels"] == got["words"] == got["words2"] == ["A", "C"]
    assert math.isclose(got["score2"], got["score"], rel_tol=1e-9)
    assert math.isclose(got["cost_u"], got["score"], rel_tol=1e-9)
