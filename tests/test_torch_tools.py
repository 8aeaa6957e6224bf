"""PyTorch port vs JAX: the tool chain on the reference's toy corpus
(``rasr_tpu_torch/tools/``, the cases of ``tests/test_tools.py``).

Each tool runs in-process on both packages under the same arguments, the
port's with ``--*.device=cpu``, each package in its own copy of the toy
workdir, and what they write is compared: WER lines, CTM and n-best
words exactly; features and the flat-start mixtures within 1e-3 (float32
sums in another order on the two sides). From the trainer on, both
packages decode with the JAX-trained mixtures (``model.mix``): n-best and
best-path scores agree to 1e-4, and the lattices have as many nodes and
arcs (not the same ones: the toy's monophone network has exact score
ties, which the JAX decoder breaks in no fixed order). The port's own
mixtures decode to the same words. The artifacts carry over: a JAX-trained mixture set and
CART, and a JAX-written network image, decode in the port's recognizer
to the JAX recognizer's words.
"""

import json
import re
import shutil

import numpy as np
import pytest

from tests.tools_parity import (
    PACKAGES, archive_entries, assert_lattices_close, assert_mixtures_close, both,
    log_records, package_dirs, recognized, run, toy_corpus, wer_lines,
)

SR = [
    "--speech-recognizer.corpus-file=toy.corpus",
    "--speech-recognizer.lexicon-file=lexicon.xml",
    "--speech-recognizer.lm-file=lm.arpa",
    "--speech-recognizer.states-per-phone=1",
    "--speech-recognizer.search.lm-scale=2.0",
    "--speech-recognizer.search.max-hyps=128",
    "--speech-recognizer.frontend.normalize=none",
]
AMT = [
    "--acoustic-model-trainer.corpus-file=toy.corpus",
    "--acoustic-model-trainer.lexicon-file=lexicon.xml",
    "--acoustic-model-trainer.states-per-phone=1",
    "--acoustic-model-trainer.frontend.normalize=none",
]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The reference's full tool chain on both packages: corpus
    statistics, features, archive listing, flat-start training, the
    recognizer with lattices / CTM / n-best / log, the across-word
    recognizer, flf-tool and log-analysis."""
    dirs = package_dirs(tmp_path_factory.mktemp("tools"), toy_corpus)
    out = {}
    out["stats"] = both("corpus_statistics", "--corpus-statistics.corpus-file=toy.corpus",
                        dirs=dirs)
    both("feature_extraction", "--feature-extraction.corpus-file=toy.corpus",
         "--feature-extraction.cache=feat.cache", "--feature-extraction.frontend.normalize=none",
         dirs=dirs)
    out["listing"] = both("archiver", "--archiver.mode=list", "--archiver.archive=feat.cache",
                          dirs=dirs)
    both("acoustic_model_trainer", *AMT, "--acoustic-model-trainer.action=train",
         "--acoustic-model-trainer.iterations=5",
         "--acoustic-model-trainer.new-mixture-file=own.mix", dirs=dirs)
    for pkg in PACKAGES:
        shutil.copy(dirs["jax"] / "own.mix.npz", dirs[pkg] / "model.mix.npz")
    out["own"] = run("torch", "speech_recognizer", *SR, "--speech-recognizer.mixture-file=own.mix",
                     "--speech-recognizer.log-file=own.log", cwd=dirs["torch"])[0]
    out["rec"] = both("speech_recognizer", *SR, "--speech-recognizer.mixture-file=model.mix",
                      "--speech-recognizer.lattice-archive=lat.cache",
                      "--speech-recognizer.ctm-file=out.ctm",
                      "--speech-recognizer.nbest-file=out.nbest",
                      "--speech-recognizer.nbest=3",
                      "--speech-recognizer.log-file=rec.log", dirs=dirs)
    out["across"] = both("speech_recognizer", *SR, "--speech-recognizer.mixture-file=model.mix",
                         "--speech-recognizer.across-word=true", dirs=dirs)
    out["flf"] = both("flf_tool", "--flf-tool.lattice-archive=lat.cache",
                      "--flf-tool.corpus-file=toy.corpus",
                      "--flf-tool.ops=prune best evaluate oracle", dirs=dirs)
    out["analysis"] = both("log_analysis", "--log-analysis.json=true", "rec.log", dirs=dirs)
    return dirs, out


def test_full_tool_chain(chain):
    dirs, out = chain
    assert json.loads(out["stats"]["torch"]) == json.loads(out["stats"]["jax"])
    assert json.loads(out["stats"]["torch"])["segments"] == 8
    assert out["listing"]["torch"] == out["listing"]["jax"]
    assert len(out["listing"]["torch"].splitlines()) == 8
    feats = {pkg: archive_entries(dirs[pkg] / "feat.cache", pkg) for pkg in PACKAGES}
    assert sorted(feats["torch"]) == sorted(feats["jax"])
    from rasr_tpu_torch.utils.archive import unpack_ndarray

    for k in feats["jax"]:
        np.testing.assert_allclose(unpack_ndarray(feats["torch"][k]),
                                   unpack_ndarray(feats["jax"][k]), rtol=1e-4, atol=1e-3)
    # flat-start EM from the same features: parameters within 1e-3
    assert_mixtures_close(dirs["torch"] / "own.mix.npz", dirs["jax"] / "own.mix.npz")
    assert wer_lines(out["own"]) == wer_lines(out["rec"]["jax"])
    assert recognized(dirs["torch"] / "own.log") == recognized(dirs["jax"] / "rec.log")
    for key in ("rec", "across", "flf"):
        assert wer_lines(out[key]["torch"]) == wer_lines(out[key]["jax"]), key
    assert "WER: 0.0000" in out["rec"]["torch"] and "oracle WER: 0.0000" in out["flf"]["torch"]
    assert recognized(dirs["torch"] / "rec.log") == recognized(dirs["jax"] / "rec.log")
    ctm = {pkg: (dirs[pkg] / "out.ctm").read_text() for pkg in PACKAGES}
    assert ctm["torch"] == ctm["jax"] and len(ctm["torch"].splitlines()) == 16
    nbest = {pkg: [line.split() for line in (dirs[pkg] / "out.nbest").read_text().splitlines()]
             for pkg in PACKAGES}
    assert [r[:2] + r[3:] for r in nbest["torch"]] == [r[:2] + r[3:] for r in nbest["jax"]]
    np.testing.assert_allclose([float(r[2]) for r in nbest["torch"]],
                               [float(r[2]) for r in nbest["jax"]], rtol=1e-4)
    assert_lattices_close(dirs["torch"] / "lat.cache", dirs["jax"] / "lat.cache")
    summary = {pkg: json.loads(out["analysis"][pkg]) for pkg in PACKAGES}
    assert summary["torch"]["total"] == summary["jax"]["total"]
    assert summary["torch"]["segments"] == 8 and summary["torch"]["total"]["wer"] == 0.0


def test_log_analysis_aggregation(tmp_path):
    """analyze(): multi-log merge, per-speaker split, unscored segments —
    the same report from both packages."""
    from rasr_tpu.tools import log_analysis as jla
    from rasr_tpu_torch.tools import log_analysis as tla

    recs = [
        {"msg": "recognized", "channel": "statistics", "segment": "c/r0/s",
         "speaker": "spk1", "reference": "A B", "recognized": "A B",
         "score": 10.0, "frames": 100, "rtf": 0.02},
        {"msg": "recognized", "segment": "c/r1/s", "speaker": "spk2",
         "reference": "A B C", "recognized": "A X", "score": 20.0, "frames": 200, "rtf": 0.04},
        {"msg": "recognized", "segment": "c/r2/s", "speaker": "", "reference": "",
         "recognized": "B", "score": 5.0, "frames": 50, "rtf": 0.01},
        {"msg": "not recognition", "channel": "log"},
    ]
    log1, log2 = tmp_path / "a.log", tmp_path / "b.log"
    log1.write_text("\n".join(json.dumps(r) for r in recs[:2]) + "\n")
    log2.write_text("\n".join(json.dumps(r) for r in recs[2:]) + "\n{bad json")
    paths = [str(log1), str(log2)]
    report = tla.analyze(tla._parse_records(paths))
    assert report == jla.analyze(jla._parse_records(paths))
    t = report["total"]
    assert t["ref_len"] == 5 and t["sub"] == 1 and t["del"] == 1 and t["ins"] == 0
    assert report["worst"][0]["segment"] == "c/r1/s"


def test_tool_help_and_bad_config(chain):
    dirs, _ = chain
    helps = {pkg: run(pkg, "speech_recognizer", "--help", cwd=dirs[pkg])[0] for pkg in PACKAGES}
    assert "python -m rasr_tpu_torch.tools.speech_recognizer" in helps["torch"]
    params = {pkg: [line.split()[0] for line in text.splitlines() if line.startswith("  --")]
              for pkg, text in helps.items()}
    assert params["torch"] == params["jax"][:1] + ["--speech-recognizer.device"] + \
        params["jax"][1:]
    for pkg in PACKAGES:
        errors = __import__(f"{PACKAGES[pkg]}.utils.component", fromlist=["x"])
        with pytest.raises(errors.ParameterError):
            run(pkg, "lm_util", "--lm-util.action=bogus", "--lm-util.lm-file=x", cwd=dirs[pkg])


def test_dump_config_and_system_information(chain):
    """--dump-config prints the rules with their sources; a log-file run
    starts with the system information: torch and CUDA versions and the
    device instead of JAX's version."""
    dirs, _ = chain
    out, _ = run("torch", "corpus_statistics", "--corpus-statistics.corpus-file=toy.corpus",
                 "--dump-config", cwd=dirs["torch"])
    assert "corpus-statistics.corpus-file = toy.corpus" in out and "<cmdline>" in out
    assert "*.device = cpu   # <cmdline>" in out
    run("torch", "corpus_statistics", "--corpus-statistics.corpus-file=toy.corpus",
        "--corpus-statistics.log-file=stats.jsonl", cwd=dirs["torch"])
    records = [json.loads(line) for line in (dirs["torch"] / "stats.jsonl").read_text().splitlines()]
    first = records[0]
    assert first["msg"] == "system-information" and "hostname" in first
    assert first["torch"] and first["device"] == "cpu" and "card" not in first and "jax" not in first
    assert records[-1]["msg"] == "kernel launches" and records[-1]["gmm_scores"] == 0


def test_network_image_cache(chain):
    """--network-cache: the second run loads the image, a changed LM
    rebuilds it; an image the JAX tool wrote loads in the port's tool and
    decodes (with the JAX-trained mixtures) to the JAX tool's words."""
    dirs, _ = chain
    args = [*SR, "--speech-recognizer.mixture-file=model.mix",
            "--speech-recognizer.network-cache=net.img", "--speech-recognizer.log-file=sr.log"]
    wd = dirs["torch"]
    seen = []
    for _ in range(2):
        out, _ = run("torch", "speech_recognizer", *args, cwd=wd)
        assert "WER: 0.0000" in out
        seen.append("loaded" if "network image loaded" in (wd / "sr.log").read_text()
                    else "saved")
        (wd / "sr.log").unlink()
    assert seen == ["saved", "loaded"] and (wd / "net.img.tree.npz").exists()
    # the JAX tool's image, with its recognizer's words
    jwd = dirs["jax"]
    run("jax", "speech_recognizer", *SR, "--speech-recognizer.mixture-file=model.mix",
        "--speech-recognizer.network-cache=jnet.img", "--speech-recognizer.log-file=jsr.log",
        cwd=jwd)
    for path in jwd.glob("jnet.img*"):
        shutil.copy(path, wd / path.name)
    run("torch", "speech_recognizer", *SR, "--speech-recognizer.mixture-file=model.mix",
        "--speech-recognizer.network-cache=jnet.img", "--speech-recognizer.log-file=tsr.log",
        cwd=wd)
    assert "network image loaded" in (wd / "tsr.log").read_text()
    assert recognized(wd / "tsr.log") == recognized(jwd / "jsr.log")
    # the same model and network: the same scores (float32 sums in another order)
    scores = [[r["score"] for r in log_records(path) if r.get("msg") == "recognized"]
              for path in (wd / "tsr.log", jwd / "jsr.log")]
    np.testing.assert_allclose(scores[0], scores[1], rtol=1e-5)
    # touch the LM -> stale key -> rebuild
    (wd / "lm.arpa").write_text((wd / "lm.arpa").read_text() + "\n")
    out, _ = run("torch", "speech_recognizer", *args, cwd=wd)
    assert "WER: 0.0000" in out and "network image saved" in (wd / "sr.log").read_text()
    shutil.copy(dirs["jax"] / "lm.arpa", wd / "lm.arpa")


def test_recognizer_bigram_lookahead(chain):
    """--search.lookahead-order=2 (round trip through the image) and the
    order-3 / smoothed / corr-scaled / survivor knobs: the WER lines of
    both packages."""
    dirs, _ = chain
    base = [*SR, "--speech-recognizer.mixture-file=model.mix",
            "--speech-recognizer.search.lookahead-classes=8"]
    la2 = [*base, "--speech-recognizer.search.lookahead-order=2",
           "--speech-recognizer.network-cache=net2.img"]
    first = both("speech_recognizer", *la2, dirs=dirs)
    assert (dirs["torch"] / "net2.img.la.npz").exists()
    again = run("torch", "speech_recognizer", *la2, "--speech-recognizer.log-file=la.log",
                cwd=dirs["torch"])[0]
    assert "network image loaded" in (dirs["torch"] / "la.log").read_text()
    la3 = both("speech_recognizer", *base, "--speech-recognizer.search.lookahead-order=3",
               "--speech-recognizer.search.lookahead-smooth=1.0",
               "--speech-recognizer.search.lookahead-corr-scale=0.5",
               "--speech-recognizer.search.lookahead-update=survivor", dirs=dirs)
    for out in (first, la3):
        assert wer_lines(out["torch"]) == wer_lines(out["jax"]) == ["WER: 0.0000 (0 errors / "
                                                                    "16 words)"]
    assert wer_lines(again) == wer_lines(first["torch"])


def test_recognize_from_feature_cache(chain):
    """--feature-cache decodes the cached features (no audio, no
    frontend); the port reads the JAX tool's cache."""
    dirs, _ = chain
    args = [*SR, "--speech-recognizer.mixture-file=model.mix"]
    out = both("speech_recognizer", *args, "--speech-recognizer.feature-cache=feat.cache",
               dirs=dirs)
    assert wer_lines(out["torch"]) == wer_lines(out["jax"])
    assert "WER: 0.0000" in out["torch"]
    shutil.copy(dirs["jax"] / "feat.cache", dirs["torch"] / "jfeat.cache")
    shutil.copy(dirs["jax"] / "feat.cache", dirs["jax"] / "jfeat.cache")
    out2 = both("speech_recognizer", *args, "--speech-recognizer.feature-cache=jfeat.cache",
                "--speech-recognizer.lattice-archive=flat.cache", dirs=dirs)
    assert wer_lines(out2["torch"]) == wer_lines(out["jax"])
    assert_lattices_close(dirs["torch"] / "flat.cache", dirs["jax"] / "flat.cache")


def test_estimate_cart_and_triphone_recognition(chain):
    """estimate-cart runs on both packages and ties the toy's states into
    at most the leaves asked for (the JSON itself is held equal on shared
    statistics in ``tests/test_torch_cart.py``: on this toy several
    questions split the examples identically or with a gain near 0, and
    the two frontends' 1e-5 differences pick among them). Triphone
    training under the JAX tool's CART gives close mixtures and the same
    WER on both packages, and the JAX tool's CART and triphone mixtures
    decode in the port's recognizer to the JAX recognizer's words."""
    from rasr_tpu_torch.corpus.lexicon import Lexicon
    from rasr_tpu_torch.models.cart import CartTree
    from rasr_tpu_torch.models.tying import CartStateTying

    dirs, _ = chain
    both("acoustic_model_trainer", *AMT, "--acoustic-model-trainer.action=estimate-cart",
         "--acoustic-model-trainer.mixture-file=model.mix",
         "--acoustic-model-trainer.cart-output-file=own-cart.json",
         "--acoustic-model-trainer.cart-max-leaves=6", dirs=dirs)
    lex = Lexicon.load(str(dirs["torch"] / "lexicon.xml"))
    for pkg in PACKAGES:
        tree = CartTree.load(str(dirs[pkg] / "own-cart.json"))
        assert 2 <= CartStateTying(tree, lex).num_classes <= 6
    for pkg in PACKAGES:
        shutil.copy(dirs["jax"] / "own-cart.json", dirs[pkg] / "cart.json")
    both("acoustic_model_trainer", *AMT, "--acoustic-model-trainer.action=train",
         "--acoustic-model-trainer.iterations=4", "--acoustic-model-trainer.cart-file=cart.json",
         "--acoustic-model-trainer.new-mixture-file=tri.mix", dirs=dirs)
    assert_mixtures_close(dirs["torch"] / "tri.mix.npz", dirs["jax"] / "tri.mix.npz")
    args = [*SR, "--speech-recognizer.cart-file=cart.json"]
    out = both("speech_recognizer", *args, "--speech-recognizer.mixture-file=tri.mix",
               "--speech-recognizer.log-file=tri.log", dirs=dirs)
    assert wer_lines(out["torch"]) == wer_lines(out["jax"]) and "WER: 0.0000" in out["torch"]
    shutil.copy(dirs["jax"] / "tri.mix.npz", dirs["torch"] / "jtri.mix.npz")
    run("torch", "speech_recognizer", *args, "--speech-recognizer.mixture-file=jtri.mix",
        "--speech-recognizer.log-file=jtri.log", cwd=dirs["torch"])
    assert recognized(dirs["torch"] / "jtri.log") == recognized(dirs["jax"] / "tri.log")


def test_flf_structural_ops(chain):
    """flf-tool union / intersect / map / scale / confidence: the same WER
    and close output lattices on both packages."""
    dirs, _ = chain
    for pkg in PACKAGES:
        (dirs[pkg] / "orth.map").write_text("ZZZ QQQ\n")
    out = both("flf_tool", "--flf-tool.lattice-archive=lat.cache",
               "--flf-tool.second-archive=lat.cache", "--flf-tool.map-file=orth.map",
               "--flf-tool.corpus-file=toy.corpus",
               "--flf-tool.ops=scale union intersect map confidence best evaluate",
               "--flf-tool.output-archive=lat2.cache", dirs=dirs)
    assert wer_lines(out["torch"]) == wer_lines(out["jax"]) == ["WER: 0.0000"]
    assert_lattices_close(dirs["torch"] / "lat2.cache", dirs["jax"] / "lat2.cache")


def test_doc_gen_names_the_port_tools(capsys):
    """doc_gen imports the tools by string: the port's list must name the
    port's modules and document the ``device`` parameter."""
    from rasr_tpu_torch.tools import doc_gen

    mods = [(m, cls.__module__) for m, cls in doc_gen.tool_classes()]
    assert [m for m, _ in mods] == doc_gen.TOOLS
    assert all(mod.startswith("rasr_tpu_torch.tools.") for _, mod in mods)
    assert doc_gen.main() == 0
    text = capsys.readouterr().out
    assert len(re.findall(r"^## ", text, re.M)) == len(doc_gen.TOOLS)
    assert "python -m rasr_tpu.tools" not in text and "`--speech-recognizer.device`" in text
    assert "rasr_tpu." not in re.sub(r"rasr_tpu_torch", "", text)
