"""PyTorch port vs JAX: the adaptation tools (VTLN estimation and warped
extraction, fMLLR and the SAT accumulation, model-space MLLR with the
recognizer's speaker selection: the cases of ``tests/test_tools.py`` on
its two-speaker corpora).

Both packages start from the same JAX-trained mixtures. VTLN tables are
held equal (a grid search over the same seven factors), warped features
within 1e-3, MLLR-adapted means within 1e-3 (float32 statistics in
another order, then the same float64 host solve), per-speaker fMLLR gains
within 1e-3 and WER lines exactly. The fMLLR transforms themselves are
not compared entry by entry: on these 16-dim tone features the auxiliary
function is flat along some directions, so the two packages' 1e-5
feature differences move entries by up to ~0.4 at equal gains; the SAT
statistics are held from the same (JAX's) transforms.
"""

import json
import re
import shutil

import numpy as np
import pytest

from tests.tools_parity import (
    LEXICON, PACKAGES, archive_entries, assert_mixtures_close, both, package_dirs, run,
    wer_lines,
)

AMT = ["--acoustic-model-trainer.lexicon-file=lex.xml",
       "--acoustic-model-trainer.states-per-phone=1",
       "--acoustic-model-trainer.frontend.normalize=none"]
SR = ["--speech-recognizer.lexicon-file=lex.xml", "--speech-recognizer.states-per-phone=1",
      "--speech-recognizer.search.lm-scale=2.0", "--speech-recognizer.search.max-hyps=128",
      "--speech-recognizer.frontend.normalize=none"]


def _vtln_inputs(tmp):
    """The reference's VTLN corpus: speaker B's tones stretched by 1.18."""
    from rasr_tpu_torch.corpus.audio import write_wav

    rng = np.random.default_rng(5)
    sr = 16000
    base = {"a": 500.0, "b": 1800.0}

    def utt(scale):
        audio = [(0.002 * rng.normal(size=2400)).astype(np.float32)]
        for p in ("a", "b", "a"):
            t = np.arange(int(0.25 * sr)) / sr
            audio.append((0.3 * np.sin(2 * np.pi * base[p] * scale * t)).astype(np.float32))
            audio.append((0.002 * rng.normal(size=2400)).astype(np.float32))
        return np.concatenate(audio)

    xml = ['<corpus name="v">']
    for spk, scale, n in (("spkA", 1.0, 3), ("spkB", 1.18, 3)):
        for i in range(n):
            a = utt(scale)
            write_wav(str(tmp / f"{spk}{i}.wav"), a, sr)
            xml.append(f'<recording name="{spk}{i}" audio="{spk}{i}.wav">'
                       f'<segment name="s" start="0" end="{len(a)/sr}">'
                       f'<speaker name="{spk}"/><orth>ABA</orth></segment></recording>')
    xml.append("</corpus>")
    (tmp / "v.corpus").write_text("".join(xml))
    (tmp / "lex.xml").write_text(LEXICON.replace(
        "<lemma><orth>AB</orth><phon>a b</phon></lemma>"
        "<lemma><orth>BA</orth><phon>b a</phon></lemma>",
        "<lemma><orth>ABA</orth><phon>a b a</phon></lemma>"))


def _gain_inputs(tmp):
    """The reference's gain-mismatch corpus: speaker B at 1/15 the level."""
    from rasr_tpu_torch.corpus.audio import write_wav
    from rasr_tpu_torch.models.lm.arpa import NgramLm

    rng = np.random.default_rng(7)
    sr = 16000
    ph = {"a": 500.0, "b": 1800.0}

    def utt(words, amp):
        audio = [(amp / 100 * rng.normal(size=2400)).astype(np.float32)]
        for w in words:
            for p in {"AB": "ab", "BA": "ba"}[w]:
                t = np.arange(int(0.25 * sr)) / sr
                audio.append((amp * np.sin(2 * np.pi * ph[p] * t)).astype(np.float32))
            audio.append((amp / 100 * rng.normal(size=2400)).astype(np.float32))
        return np.concatenate(audio)

    texts = [["AB", "BA"], ["BA", "AB"], ["AB", "AB"]]
    recs = {"spkA": [], "spkB": []}
    for spk, amp in (("spkA", 0.3), ("spkB", 0.02)):
        for i, ws in enumerate(texts):
            a = utt(ws, amp)
            write_wav(str(tmp / f"{spk}{i}.wav"), a, sr)
            recs[spk].append(
                f'<recording name="{spk}{i}" audio="{spk}{i}.wav">'
                f'<segment name="s" start="0" end="{len(a)/sr}">'
                f'<speaker name="{spk}"/><orth>{" ".join(ws)}</orth></segment></recording>')
    (tmp / "f.corpus").write_text(
        '<corpus name="f">' + "".join(recs["spkA"] + recs["spkB"]) + "</corpus>")
    (tmp / "fA.corpus").write_text('<corpus name="f">' + "".join(recs["spkA"]) + "</corpus>")
    (tmp / "lex.xml").write_text(LEXICON)
    NgramLm.train_from_text(texts, order=2).write_arpa(str(tmp / "f.arpa"))


def _with_jax_model(tmp, populate, corpus, name, iterations=4):
    dirs = package_dirs(tmp, populate)
    run("jax", "acoustic_model_trainer", "--acoustic-model-trainer.action=train",
        f"--acoustic-model-trainer.corpus-file={corpus}",
        f"--acoustic-model-trainer.iterations={iterations}",
        f"--acoustic-model-trainer.new-mixture-file={name}", *AMT, cwd=dirs["jax"])
    shutil.copy(dirs["jax"] / f"{name}.npz", dirs["torch"] / f"{name}.npz")
    return dirs


@pytest.fixture(scope="module")
def gain(tmp_path_factory):
    return _with_jax_model(tmp_path_factory.mktemp("adapt"), _gain_inputs, "fA.corpus", "f.mix")


def test_vtln_estimate_and_extract(tmp_path):
    """estimate-vtln gives both packages the same per-speaker factors
    (speaker B off 1.0, A at 1.0); extraction through the table gives
    close warped features."""
    from rasr_tpu_torch.utils.archive import unpack_ndarray

    dirs = _with_jax_model(tmp_path, _vtln_inputs, "v.corpus", "vt.mix")
    both("acoustic_model_trainer", "--acoustic-model-trainer.action=estimate-vtln",
         "--acoustic-model-trainer.corpus-file=v.corpus",
         "--acoustic-model-trainer.mixture-file=vt.mix",
         "--acoustic-model-trainer.vtln-output-file=vtln.json", *AMT, dirs=dirs)
    tables = {pkg: json.loads((dirs[pkg] / "vtln.json").read_text()) for pkg in PACKAGES}
    assert tables["torch"] == tables["jax"] and set(tables["torch"]) == {"spkA", "spkB"}
    assert tables["torch"]["spkB"] != tables["torch"]["spkA"]
    both("feature_extraction", "--feature-extraction.corpus-file=v.corpus",
         "--feature-extraction.cache=vt.cache", "--feature-extraction.vtln-warp-file=vtln.json",
         "--feature-extraction.frontend.normalize=none", dirs=dirs)
    got, want = (archive_entries(dirs[pkg] / "vt.cache", pkg) for pkg in ("torch", "jax"))
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        np.testing.assert_allclose(unpack_ndarray(got[k]), unpack_ndarray(want[k]),
                                   rtol=1e-4, atol=1e-3)


def test_fmllr_estimate_and_adapted_recognition(gain):
    """estimate-fmllr: close gains (the mismatched speaker gains far
    more); recognition with each package's transforms at the same WER;
    the SAT accumulate + estimate from the JAX tool's transforms gives
    close mixtures."""
    dirs = gain
    out = {pkg: run(pkg, "acoustic_model_trainer", "--acoustic-model-trainer.action=estimate-fmllr",
                    "--acoustic-model-trainer.corpus-file=f.corpus",
                    "--acoustic-model-trainer.mixture-file=f.mix",
                    "--acoustic-model-trainer.fmllr-output-file=fmllr.json",
                    "--acoustic-model-trainer.fmllr-min-count=50", *AMT, cwd=dirs[pkg])[1]
           for pkg in PACKAGES}
    tables = {pkg: json.loads((dirs[pkg] / "fmllr.json").read_text()) for pkg in PACKAGES}
    assert set(tables["torch"]) == set(tables["jax"]) == {"spkA", "spkB"}
    gains = {pkg: {k: float(v) for k, v in re.findall(
        r"fmllr speaker speaker=(\S+).*?gain=([-\d.e+]+)", out[pkg])} for pkg in PACKAGES}
    for spk in ("spkA", "spkB"):
        np.testing.assert_allclose(gains["torch"][spk], gains["jax"][spk], rtol=1e-3, atol=1e-3)
    assert gains["torch"]["spkB"] > gains["torch"]["spkA"] + 1.0 > 1.0
    rec = both("speech_recognizer", *SR, "--speech-recognizer.corpus-file=f.corpus",
               "--speech-recognizer.lm-file=f.arpa", "--speech-recognizer.mixture-file=f.mix",
               "--speech-recognizer.fmllr-file=fmllr.json", dirs=dirs)
    assert wer_lines(rec["torch"]) == wer_lines(rec["jax"]) and "WER: 0.0000" in rec["torch"]
    shutil.copy(dirs["jax"] / "fmllr.json", dirs["torch"] / "jfmllr.json")
    shutil.copy(dirs["jax"] / "fmllr.json", dirs["jax"] / "jfmllr.json")
    both("acoustic_model_trainer", "--acoustic-model-trainer.action=accumulate",
         "--acoustic-model-trainer.corpus-file=f.corpus",
         "--acoustic-model-trainer.mixture-file=f.mix",
         "--acoustic-model-trainer.fmllr-file=jfmllr.json",
         "--acoustic-model-trainer.accumulator-file=sat.acc", *AMT, dirs=dirs)
    both("acoustic_model_trainer", "--acoustic-model-trainer.action=estimate",
         "--acoustic-model-trainer.accumulator-file=sat.acc",
         "--acoustic-model-trainer.mixture-file=f.mix",
         "--acoustic-model-trainer.new-mixture-file=sat.mix", *AMT, dirs=dirs)
    assert_mixtures_close(dirs["torch"] / "sat.mix.npz", dirs["jax"] / "sat.mix.npz")


def test_mllr_estimate_and_speaker_decode(gain):
    """estimate-mllr: close per-speaker adapted means (the mismatched
    speaker's move far more); decoding speaker B alone with its adapted
    set gives the same WER line on both packages."""
    dirs = gain
    both("acoustic_model_trainer", "--acoustic-model-trainer.action=estimate-mllr",
         "--acoustic-model-trainer.corpus-file=f.corpus",
         "--acoustic-model-trainer.mixture-file=f.mix",
         "--acoustic-model-trainer.mllr-min-count=50", *AMT, dirs=dirs)
    index = {pkg: json.loads((dirs[pkg] / "mllr-index.json").read_text()) for pkg in PACKAGES}
    assert index["torch"] == index["jax"] and set(index["torch"]) == {"spkA", "spkB"}
    for spk, path in index["jax"].items():
        assert_mixtures_close(dirs["torch"] / f"{path}.npz", dirs["jax"] / f"{path}.npz")
    base = np.load(dirs["torch"] / "f.mix.npz")["means"]
    shift = {spk: np.abs(np.load(dirs["torch"] / f"{p}.npz")["means"] - base).mean()
             for spk, p in index["torch"].items()}
    assert shift["spkB"] > 2.0 * shift["spkA"]
    rec = both("speech_recognizer", *SR, "--speech-recognizer.corpus-file=f.corpus",
               "--speech-recognizer.lm-file=f.arpa",
               "--speech-recognizer.mixture-file=mllr-spkB.mix",
               "--speech-recognizer.speaker=spkB", dirs=dirs)
    assert wer_lines(rec["torch"]) == wer_lines(rec["jax"])
    assert "WER: 0.0000" in rec["torch"] and "/ 6 words" in rec["torch"]


def test_empty_segment_selection_raises(gain):
    """A speaker selection that matches nothing fails in both packages
    instead of printing a WER of 0 over no words."""
    for pkg in PACKAGES:
        _, err = run(pkg, "speech_recognizer", *SR, "--speech-recognizer.corpus-file=f.corpus",
                     "--speech-recognizer.lm-file=f.arpa",
                     "--speech-recognizer.mixture-file=f.mix",
                     "--speech-recognizer.speaker=nobody", cwd=gain[pkg], rc=1)
        assert "segment selection matched no segments" in err
