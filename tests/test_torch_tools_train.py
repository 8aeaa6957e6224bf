"""PyTorch port vs JAX: the training-side tools on the reference's toy
corpus (alignment, the nn-trainer, lm-util, fsa, lattice-processor,
train-mmi, cache-driven accumulation, RNN-LM fusion and rescoring: the
cases of ``tests/test_tools.py`` beyond the recognizer chain).

Both packages start from the same JAX-trained mixtures and the same
feature cache, so what each tool writes is compared directly: alignments
and priors exactly, statistics and mixtures within 1e-3 relative (float32
sums in another order; acoustically rescored lattices' best paths within
1e-3), WER lines exactly and perplexities within 1e-4. The nn-trainers
start from the same initial weights (the JAX tool's draw, carried over by
``convert.nn_params_from_flax``): per-epoch losses and objectives within
1e-5 relative, trained parameters within 1e-5 absolute + 1e-4 relative.
Networks and RNN LMs cross from the JAX tools to the port's through
``convert.nn_params_from_flax`` / ``convert.rnn_lm_from_flax`` (the JAX
tools write flax's msgpack; the port's ``torch.save``), and then decode to
the JAX tools' words.
"""

import re
import shutil

import numpy as np
import pytest
import torch

from tests.tools_parity import (
    PACKAGES, TEXTS, archive_entries, assert_lattices_close, assert_mixtures_close, both,
    package_dirs, recognized, run, toy_corpus, wer_lines,
)

#: networks trained by both nn-trainers from the same initial weights:
#: per-epoch losses and objectives within LOSS_RTOL, parameters within
#: PARAM_ATOL + PARAM_RTOL (as ``tests/test_torch_trainer.py`` holds the
#: trainers themselves)
LOSS_RTOL, PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-5, 1e-4
#: LF-MMI / sMBR losses and objectives: 1e-4 relative, as
#: ``tests/test_torch_lfmmi.py`` holds them (float32 forward-backward sums
#: in another order, carried through the epochs' Adam steps)
SEQUENCE_RTOL = 1e-4
FEATURE_DIM = 16  # the toy frontend's MFCCs
SEQUENCE_EPOCHS = 4

COMMON = {
    "amt": ["--acoustic-model-trainer.corpus-file=toy.corpus",
            "--acoustic-model-trainer.lexicon-file=lexicon.xml",
            "--acoustic-model-trainer.states-per-phone=1",
            "--acoustic-model-trainer.frontend.normalize=none"],
    "sr": ["--speech-recognizer.corpus-file=toy.corpus",
           "--speech-recognizer.lexicon-file=lexicon.xml",
           "--speech-recognizer.lm-file=lm.arpa",
           "--speech-recognizer.states-per-phone=1",
           "--speech-recognizer.search.lm-scale=2.0",
           "--speech-recognizer.search.max-hyps=128",
           "--speech-recognizer.frontend.normalize=none"],
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The toy corpus with JAX's features, mixtures, alignments and
    lattices in both package directories."""
    tmp = tmp_path_factory.mktemp("train_tools")
    dirs = package_dirs(tmp, toy_corpus)
    jd = dirs["jax"]
    run("jax", "feature_extraction", "--feature-extraction.corpus-file=toy.corpus",
        "--feature-extraction.cache=feat.cache", "--feature-extraction.frontend.normalize=none",
        cwd=jd)
    run("jax", "acoustic_model_trainer", *COMMON["amt"], "--acoustic-model-trainer.action=train",
        "--acoustic-model-trainer.iterations=5",
        "--acoustic-model-trainer.new-mixture-file=model.mix", cwd=jd)
    run("jax", "speech_recognizer", *COMMON["sr"], "--speech-recognizer.mixture-file=model.mix",
        "--speech-recognizer.lattice-archive=lat.cache", cwd=jd)
    for name in ("feat.cache", "model.mix.npz", "lat.cache"):
        shutil.copy(jd / name, dirs["torch"] / name)
    both("acoustic_model_trainer", *COMMON["amt"], "--acoustic-model-trainer.action=align",
         "--acoustic-model-trainer.mixture-file=model.mix",
         "--acoustic-model-trainer.alignment-cache=align.cache", dirs=dirs)
    return dirs


def test_align_and_priors(work):
    """Alignments of both packages agree state for state; the priors
    estimated from them too."""
    from rasr_tpu_torch.align.aligner import Alignment

    got, want = (archive_entries(work[pkg] / "align.cache", pkg) for pkg in ("torch", "jax"))
    assert sorted(got) == sorted(want) and len(got) == 8
    for k in want:
        a, b = Alignment.unpack(k, got[k]), Alignment.unpack(k, want[k])
        np.testing.assert_array_equal(a.emission_ids, b.emission_ids)
        np.testing.assert_array_equal(a.state_indices, b.state_indices)
    both("nn_trainer", "--nn-trainer.action=estimate-priors",
         "--nn-trainer.feature-cache=feat.cache", "--nn-trainer.alignment-cache=align.cache",
         "--nn-trainer.priors-file=priors.npy", dirs=work)
    np.testing.assert_array_equal(np.load(work["torch"] / "priors.npy"),
                                  np.load(work["jax"] / "priors.npy"))


def _flax_init(module, dummy):
    """``module``'s flax parameters as the JAX tools draw them (seed 0)."""
    import jax

    return module.init(jax.random.PRNGKey(0), dummy)["params"]


def _assert_trained_alike(model, jax_file, template, port_file):
    """The port's parameter file within PARAM_ATOL + PARAM_RTOL of the JAX
    tool's (read with ``template``, carried over by ``nn_params_from_flax``)."""
    from rasr_tpu.train.nn_trainer import NnTrainer as JaxTrainer
    from rasr_tpu_torch.convert import nn_params_from_flax
    from rasr_tpu_torch.train.nn_trainer import NnTrainer

    want = nn_params_from_flax(model, JaxTrainer.load_params(template, str(jax_file)))
    got = NnTrainer.load_params(str(port_file))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)


def _epoch_stats(err, *keys):
    """Per-epoch values of ``keys`` from a tool's log on stderr."""
    return {k: [float(m) for m in re.findall(rf"\b{k}=([-\d.e+]+)", err)] for k in keys}


def test_nn_trainer_and_hybrid_recognition(work, monkeypatch):
    """Both nn-trainers train an FFNN (3 epochs) and a conformer (1 epoch)
    on the caches from the JAX tool's initial weights (the port's draw
    patched to them): the same loss and frame accuracy each epoch, the
    same parameters and priors. The port's network then decodes in the
    port's hybrid recognizer to the JAX recognizer's words, and the JAX
    tool's network, carried over by ``nn_params_from_flax``, does too."""
    import jax.numpy as jnp

    from rasr_tpu.models import nn as jnn
    from rasr_tpu_torch.convert import nn_params_from_flax
    from rasr_tpu_torch.models import nn as tnn
    from rasr_tpu_torch.train import nn_trainer as tnt

    td, jd = work["torch"], work["jax"]
    D = FEATURE_DIM
    inits = {tnn.FeedForwardNet: _flax_init(jnn.FeedForwardNet(num_classes=3, hidden=(16,)),
                                            jnp.zeros((2, D))),
             tnn.ConformerEncoderNet: _flax_init(
                 jnn.ConformerEncoderNet(num_classes=3, d_model=16, num_blocks=1),
                 jnp.zeros((2, 4, D)))}

    def init_from_flax(self, seed=None):
        self.model.load_state_dict(nn_params_from_flax(self.model, inits[type(self.model)]))
        return self.model.state_dict()

    monkeypatch.setattr(tnt.NnTrainer, "init_params", init_from_flax)
    nn_args = ["--nn-trainer.feature-cache=feat.cache", "--nn-trainer.alignment-cache=align.cache",
               "--nn-trainer.hidden-layers=16"]
    for kind, epochs, model in (
            ("ffnn", 3, tnn.FeedForwardNet(3, D, hidden=(16,), device="cpu")),
            ("conformer", 1, tnn.ConformerEncoderNet(3, D, d_model=16, num_blocks=1,
                                                     device="cpu"))):
        args = ["--nn-trainer.action=supervised-training", *nn_args,
                f"--nn-trainer.model-type={kind}", f"--nn-trainer.epochs={epochs}",
                f"--nn-trainer.params-file={kind}.msgpack",
                f"--nn-trainer.priors-file={kind}-priors.npy"]
        got, want = (_epoch_stats(run(pkg, "nn_trainer", *args, cwd=work[pkg])[1], "loss",
                                  "frame_accuracy") for pkg in ("torch", "jax"))
        assert len(want["loss"]) == epochs and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=f"{kind} {k}")
        _assert_trained_alike(model, jd / f"{kind}.msgpack", inits[type(model)],
                              td / f"{kind}.msgpack")
        np.testing.assert_array_equal(np.load(td / f"{kind}-priors.npy"),
                                      np.load(jd / f"{kind}-priors.npy"))
    hybrid = [*COMMON["sr"], "--speech-recognizer.feature-scorer-type=nn-hybrid",
              "--speech-recognizer.nn-priors-file=ffnn-priors.npy",
              "--speech-recognizer.nn-hidden-layers=16"]
    jout, _ = run("jax", "speech_recognizer", *hybrid,
                  "--speech-recognizer.nn-params-file=ffnn.msgpack",
                  "--speech-recognizer.log-file=jnn.log", cwd=jd)
    # the port's own network, and the JAX tool's through nn_params_from_flax
    from rasr_tpu.train.nn_trainer import NnTrainer as JaxTrainer

    jparams = JaxTrainer.load_params(inits[tnn.FeedForwardNet], str(jd / "ffnn.msgpack"))
    net = tnn.FeedForwardNet(3, D, hidden=(16,), device="cpu")
    tnt.NnTrainer.save_params(nn_params_from_flax(net, jparams), str(td / "jnn.pt"))
    for params, log in (("ffnn.msgpack", "tnn.log"), ("jnn.pt", "jtnn.log")):
        tout, _ = run("torch", "speech_recognizer", *hybrid,
                      f"--speech-recognizer.nn-params-file={params}",
                      f"--speech-recognizer.log-file={log}", cwd=td)
        assert wer_lines(tout) == wer_lines(jout)
        assert recognized(td / log) == recognized(jd / "jnn.log")


def test_lm_util_fsa_and_lattice_processor(work):
    """lm-util's n-gram actions, the fsa tool and the legacy
    lattice-processor's acoustic rescoring: the same outputs."""
    import json

    for action in ("statistics", "compile-check"):
        out = both("lm_util", f"--lm-util.action={action}", "--lm-util.lm-file=lm.arpa",
                   dirs=work)
        assert json.loads(out["torch"]) == json.loads(out["jax"])
    out = both("lm_util", "--lm-util.action=perplexity", "--lm-util.lm-file=lm.arpa",
               "--lm-util.corpus-file=toy.corpus", dirs=work)
    assert json.loads(out["torch"]) == json.loads(out["jax"])
    for pkg in PACKAGES:
        (work[pkg] / "a.att").write_text("0 1 1 1 0.5\n1 0.0\n")
        (work[pkg] / "b.att").write_text("0 1 1 2 0.25\n1 0.0\n")
    both("fsa_tool", "--fsa.op=compose", "--fsa.output=c.att", "a.att", "b.att", dirs=work)
    assert (work["torch"] / "c.att").read_text() == (work["jax"] / "c.att").read_text()
    for op in ("best", "draw", "info"):
        out = both("fsa_tool", f"--fsa.op={op}", "c.att", dirs=work)
        assert out["torch"] == out["jax"]
    assert "0.75" in out["torch"] or "states=" in out["torch"]
    out = both("lattice_processor", "--lattice-processor.lattice-archive=lat.cache",
               "--lattice-processor.corpus-file=toy.corpus",
               "--lattice-processor.feature-cache=feat.cache",
               "--lattice-processor.lexicon-file=lexicon.xml",
               "--lattice-processor.mixture-file=model.mix",
               "--lattice-processor.states-per-phone=1",
               "--lattice-processor.output-archive=lat_am.cache",
               "--lattice-processor.ops=rescore-am best evaluate write", dirs=work)
    assert wer_lines(out["torch"]) == wer_lines(out["jax"]) == ["WER: 0.0000"]
    # re-aligned arc scores sum float32 costs of ~1e3 per arc in another
    # order: best-path costs (~1e2 after cancellation) within 1e-3
    assert_lattices_close(work["torch"] / "lat_am.cache", work["jax"] / "lat_am.cache",
                          rtol=1e-3)


def test_train_mmi_action(work):
    """Lattice-based MMI (EBW) from the same ML mixtures: close mixtures
    after an iteration, and both decode at the same WER."""
    both("acoustic_model_trainer", *COMMON["amt"], "--acoustic-model-trainer.action=train-mmi",
         "--acoustic-model-trainer.lm-file=lm.arpa", "--acoustic-model-trainer.iterations=1",
         "--acoustic-model-trainer.mixture-file=model.mix",
         "--acoustic-model-trainer.new-mixture-file=mmi.mix", dirs=work)
    assert_mixtures_close(work["torch"] / "mmi.mix.npz", work["jax"] / "mmi.mix.npz")
    out = both("speech_recognizer", *COMMON["sr"], "--speech-recognizer.mixture-file=mmi.mix",
               dirs=work)
    assert wer_lines(out["torch"]) == wer_lines(out["jax"]) and "WER: 0.0000" in out["torch"]


def test_cache_driven_accumulation(work):
    """action=accumulate from the feature + alignment caches equals the
    audio-driven statistics, and JAX's."""
    from rasr_tpu_torch.train.em import GmmAccumulator

    for source, extra in (("cache", ["--acoustic-model-trainer.feature-cache=feat.cache",
                                     "--acoustic-model-trainer.alignment-cache=align.cache"]),
                          ("audio", COMMON["amt"])):
        both("acoustic_model_trainer", *extra, "--acoustic-model-trainer.action=accumulate",
             "--acoustic-model-trainer.mixture-file=model.mix",
             f"--acoustic-model-trainer.accumulator-file={source}.acc", dirs=work)
    acc = {(pkg, src): GmmAccumulator.load(str(work[pkg] / f"{src}.acc"))
           for pkg in PACKAGES for src in ("cache", "audio")}
    for a, b, rtol, atol in ((("torch", "cache"), ("torch", "audio"), 1e-3, 0.1),
                             (("torch", "cache"), ("jax", "cache"), 1e-4, 1e-3),
                             (("torch", "audio"), ("jax", "audio"), 1e-3, 0.1)):
        np.testing.assert_allclose(acc[a].count, acc[b].count, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(acc[a].sum, acc[b].sum, rtol=rtol, atol=atol)


@pytest.mark.parametrize("criterion", ["mmi", "smbr"])
def test_sequence_training_actions(work, criterion):
    """nn-trainer's LF-MMI and sMBR actions through a BLSTM, both tools from
    the same initial weights (``init-params-file``: flax's msgpack for the
    JAX tool, its ``nn_params_from_flax`` state_dict for the port's): the
    same loss and objective per frame each epoch, and the same parameters.
    The port's objective falls over the epochs."""
    import flax.serialization
    import jax.numpy as jnp

    from rasr_tpu.models import nn as jnn
    from rasr_tpu_torch.convert import nn_params_from_flax
    from rasr_tpu_torch.models import nn as tnn
    from rasr_tpu_torch.train.nn_trainer import NnTrainer

    td, jd = work["torch"], work["jax"]
    init = _flax_init(jnn.BlstmEncoderNet(num_classes=3, hidden=(16,)),
                      jnp.zeros((2, 4, FEATURE_DIM)))
    (jd / "init.msgpack").write_bytes(flax.serialization.to_bytes(init))
    model = tnn.BlstmEncoderNet(3, FEATURE_DIM, hidden=(16,), device="cpu")
    NnTrainer.save_params(nn_params_from_flax(model, init), str(td / "init.msgpack"))
    args = [f"--nn-trainer.action=sequence-{criterion}-training",
            "--nn-trainer.model-type=blstm", "--nn-trainer.corpus-file=toy.corpus",
            "--nn-trainer.lexicon-file=lexicon.xml", "--nn-trainer.states-per-phone=1",
            "--nn-trainer.feature-cache=feat.cache", "--nn-trainer.alignment-cache=align.cache",
            "--nn-trainer.hidden-layers=16", "--nn-trainer.init-params-file=init.msgpack",
            f"--nn-trainer.epochs={SEQUENCE_EPOCHS}", "--nn-trainer.learning-rate=0.005",
            "--nn-trainer.optimizer=adam", f"--nn-trainer.params-file={criterion}.msgpack"]
    keys = ("loss", f"{criterion}_per_frame")
    got, want = (_epoch_stats(run(pkg, "nn_trainer", *args, cwd=work[pkg])[1], *keys)
                 for pkg in ("torch", "jax"))
    for k in keys:
        assert len(want[k]) == SEQUENCE_EPOCHS
        np.testing.assert_allclose(got[k], want[k], rtol=SEQUENCE_RTOL, err_msg=k)
    objs = got[f"{criterion}_per_frame"]
    assert objs[-1] < objs[0]
    _assert_trained_alike(model, jd / f"{criterion}.msgpack", init, td / f"{criterion}.msgpack")


def test_rnn_lm_fusion_rescoring_and_perplexity(work):
    """A JAX-trained RNN LM, carried over by ``rnn_lm_from_flax``: the
    recognizer's first-pass fusion, flf-tool's lattice rescoring and
    lm-util's perplexity give the JAX tools' results."""
    import json

    from rasr_tpu.models.lm.rnn import RnnLm as JaxRnnLm
    from rasr_tpu_torch.convert import rnn_lm_from_flax

    jlm = JaxRnnLm.train_from_text(TEXTS, embed_dim=8, hidden_dim=12, epochs=40)
    jlm.save(str(work["jax"] / "rnn_lm"))
    rnn_lm_from_flax(jlm, device="cpu").save(str(work["torch"] / "rnn_lm"))
    out = both("speech_recognizer", *COMMON["sr"], "--speech-recognizer.mixture-file=model.mix",
               "--speech-recognizer.rnn-lm-file=rnn_lm", "--speech-recognizer.search.rnn-scale=1.0",
               "--speech-recognizer.log-file=rnn.log", dirs=work)
    assert wer_lines(out["torch"]) == wer_lines(out["jax"]) and "WER: 0.0000" in out["torch"]
    assert recognized(work["torch"] / "rnn.log") == recognized(work["jax"] / "rnn.log")
    assert "rnn fusion enabled" in (work["torch"] / "rnn.log").read_text()
    out = both("flf_tool", "--flf-tool.lattice-archive=lat.cache",
               "--flf-tool.corpus-file=toy.corpus", "--flf-tool.lm-file=rnn_lm",
               "--flf-tool.lm-type=rnn", "--flf-tool.lm-scale=2.0",
               "--flf-tool.ops=rescore best evaluate", dirs=work)
    assert wer_lines(out["torch"]) == wer_lines(out["jax"]) == ["WER: 0.0000"]
    out = both("lm_util", "--lm-util.action=perplexity", "--lm-util.lm-file=rnn_lm",
               "--lm-util.lm-type=rnn", "--lm-util.corpus-file=toy.corpus", dirs=work)
    got, want = (json.loads(out[pkg].splitlines()[-1]) for pkg in ("torch", "jax"))
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-4)
    assert torch.load(str(work["torch"] / "rnn_lm.pt"), weights_only=True)
