"""A new acoustic model is new files: one that only these tests know runs
through the decode and the train job, found by ``spec.model``.

``toy_blstm.py`` (the port's ``BlstmEncoderNet`` at toy widths, its plain
reference and counts) is registered as ``benchmark.models.toy_blstm``, and
a configuration naming it, with two cells, is added to the benchmark these
tests read; no file of the harness changes. Each job then holds the toy to
its reference as it holds the conformer: the port passes, the reference in
the next lower precision in its place fails.
"""

import json
import sys

import pytest

from benchmark import run as brun
from benchmark import spec
from benchmark.jobs import align, train
from benchmark.tests import toy_blstm
from benchmark.tests.tiny import tiny_run

TOY = {"hidden": [16, 16], "scale": 1.0, "prior_scale": 1.0, "prior_counts": [1, 10]}
# between the port's readings at the tiny size and those of the reference
# with TF32 products in its place: emissions 8.9e-7 / 1.9e-4, score 1.5e-5 /
# 0.54; first gradient 1.5e-7 / 2.4e-4, change 9.1e-8 / 9.1e-5 (the losses
# of three steps differ by 2.3e-7 / 7.2e-7: TF32 moves them too little)
LIMITS = {"decode": {"features_max_abs": 0.001, "emissions_max_abs": 1e-5, "score_gap": 0.01},
          "train": {"loss_gap": 1e-5, "grad_norm_gap": 1e-5, "update_norm_gap": 1e-5}}


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """The benchmark with the toy's configuration and cells added."""
    monkeypatch.setitem(sys.modules, "benchmark.models.toy_blstm", toy_blstm)
    cfg = spec.load_json(spec.HERE / "configs" / "conformer-hybrid.json")
    del cfg["conformer"], cfg["assumed"]
    cfg.update(name="toy-blstm", scorer="toy_blstm", toy_blstm=TOY, limits=LIMITS)
    path = tmp_path / "toy-blstm.json"
    path.write_text(json.dumps(cfg))
    bench = spec.benchmark()
    bench["configs"].append({"name": "toy-blstm", "file": str(path)})
    bench["workloads"] += [{"name": "toy-decode", "config": "toy-blstm", "traffic": "corpus-ragged",
                            "chips": 1},
                           {"name": "toy-train-ce", "config": "toy-blstm", "traffic": "ce-chunks",
                            "chips": 1}]
    monkeypatch.setattr(spec, "benchmark", lambda: bench)


def _check(r):
    out = spec.job(r).run(r)
    return brun.result_line(spec.benchmark(), r, out, "cpu")


@pytest.mark.parametrize("cell", ["toy-decode", "toy-train-ce"])
def test_a_model_the_harness_has_not_seen_runs_and_passes(toy, cell):
    r = tiny_run(cell)
    assert spec.model(r.cfg) is toy_blstm
    line = _check(r)
    assert line["correct"], line["check"]


@pytest.mark.parametrize("cell", ["toy-decode", "toy-train-ce"])
def test_its_lower_precision_control_fails(toy, cell):
    line = _check(tiny_run(cell, control="tf32"))
    assert not line["correct"], line["check"]


def test_an_unknown_model_names_the_known():
    with pytest.raises(KeyError, match=r"no acoustic model 'zipformer'.*\['conformer', 'gmm'\]"):
        spec.model({"scorer": "zipformer"})


def _swapped(cell, config):
    """The tiny run of ``cell`` with the configuration ``config`` in its own's place."""
    r = tiny_run(cell)
    r.cfg = spec.load_json(spec.HERE / "configs" / f"{config}.json")
    return r


def test_the_train_job_refuses_a_model_without_a_network():
    with pytest.raises(ValueError, match="trains a network.*'gmm' has none"):
        train.run(_swapped("conformer-train-ce", "rasr-gmm-5k"))


def test_the_align_job_refuses_a_model_without_mixtures():
    with pytest.raises(ValueError, match="accumulates GMM statistics.*'conformer' has no mixtures"):
        align.run(_swapped("gmm5k-align-em", "conformer-hybrid"))
