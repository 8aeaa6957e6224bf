"""The comparison that decides ``correct`` fails its control and the faults.

Each cell's check runs here at a tiny size on the CPU, with the
configuration's own limits: the port as it is passes; the reference in the
next lower precision put in the program's place fails; and so does a run
whose timed path is broken underneath (each utterance's decoded answer
given to the next; an alignment altered where the aligner produces it; a
training step that leaves its state unchanged; a step, or statistics,
over half of the batch).
"""

import pytest

from benchmark import run as brun
from benchmark import spec
from benchmark.tests.tiny import tiny_run


def _correct(r) -> bool:
    out = spec.job(r).run(r)
    return brun.result_line(spec.benchmark(), r, out, "cpu")["correct"]


@pytest.mark.parametrize("cell", ["gmm5k-decode", "conformer-decode", "conformer-train-ce",
                                  "gmm5k-align-em"])
def test_the_port_passes(cell):
    assert _correct(tiny_run(cell))


@pytest.mark.parametrize("cell,control", [("gmm5k-decode", "tf32"), ("conformer-decode", "fp8"),
                                          ("conformer-train-ce", "fp8"), ("gmm5k-align-em", "tf32")])
def test_the_lower_precision_control_fails(cell, control):
    assert not _correct(tiny_run(cell, control=control))


@pytest.mark.parametrize("cell", ["gmm5k-decode", "conformer-decode"])
def test_an_answer_given_to_another_utterance_fails(cell, monkeypatch):
    from rasr_tpu_torch.search.decoder import TreeDecoder

    plain = TreeDecoder.results_from_walk

    def misrouted(self, payload, names=None):
        out = plain(self, payload, names)
        return out[1:] + out[:1]

    monkeypatch.setattr(TreeDecoder, "results_from_walk", misrouted)
    assert not _correct(tiny_run(cell))


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from benchmark.jobs import train

    plain = train.build

    def frozen(*a, **kw):
        trainer = plain(*a, **kw)
        trainer.opt.step = lambda closure=None: None
        return trainer

    monkeypatch.setattr(train, "build", frozen)
    assert not _correct(tiny_run("conformer-train-ce"))


def test_a_step_on_half_its_batch_fails(monkeypatch):
    from rasr_tpu_torch.train.nn_trainer import SequenceTrainer

    plain = SequenceTrainer._update

    def half(self, x, y, w):
        b = x.shape[0] // 2
        return plain(self, x[:b], y[:b], w[:b])

    monkeypatch.setattr(SequenceTrainer, "_update", half)
    assert not _correct(tiny_run("conformer-train-ce"))


def test_an_altered_alignment_fails(monkeypatch):
    from rasr_tpu_torch.align.aligner import BatchAligner

    plain = BatchAligner.align_scores

    def altered(self, scores, graphs, n_frames, names=None):
        out = plain(self, scores, graphs, n_frames, names)
        for a, g in zip(out, graphs):
            mid = a.num_frames // 2
            s = min(int(a.state_indices[mid]) + 1, g.num_states - 1)
            a.state_indices[mid:] = s
            a.emission_ids[mid:] = g.emission_ids[s]
        return out

    monkeypatch.setattr(BatchAligner, "align_scores", altered)
    assert not _correct(tiny_run("gmm5k-align-em"))


def test_statistics_of_half_the_batch_fail(monkeypatch):
    from rasr_tpu_torch.train import em

    plain = em.accumulate

    def half(acc, model, feats, labels, *a, **kw):
        b = feats.shape[0] // 2
        return plain(acc, model, feats[:b], labels[:b], *a, **kw)

    monkeypatch.setattr(em, "accumulate", half)
    assert not _correct(tiny_run("gmm5k-align-em"))
