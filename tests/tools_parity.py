"""Shared helpers of the tool parity tests (``tests/test_torch_tools*.py``):
the reference's toy corpus, and each package's tool run in-process on the
same arguments (the port's with ``--*.device=cpu``)."""

import contextlib
import importlib
import io
import os
import shutil

import numpy as np

PACKAGES = {"jax": "rasr_tpu", "torch": "rasr_tpu_torch"}
TEXTS = [["AB", "BA"], ["BA", "AB"], ["AB", "AB"], ["BA", "BA"]] * 2
LEXICON = (
    "<lexicon><phoneme-inventory>"
    "<phoneme><symbol>a</symbol></phoneme><phoneme><symbol>b</symbol></phoneme>"
    "<phoneme><symbol>si</symbol><variation>none</variation></phoneme>"
    "</phoneme-inventory>"
    '<lemma special="silence"><orth>[SILENCE]</orth><phon>si</phon><synt/><eval/></lemma>'
    "<lemma><orth>AB</orth><phon>a b</phon></lemma>"
    "<lemma><orth>BA</orth><phon>b a</phon></lemma></lexicon>"
)


def tool_class(pkg, module):
    mod = importlib.import_module(f"{PACKAGES[pkg]}.tools.{module}")
    app = importlib.import_module(f"{PACKAGES[pkg]}.tools.application").Application
    (cls,) = [v for v in vars(mod).values() if isinstance(v, type) and issubclass(v, app)
              and v is not app and v.__module__ == mod.__name__]
    return cls


def run(pkg, module, *args, cwd, rc=0):
    """``<pkg>.tools.<module>`` in-process in ``cwd`` -> (stdout, stderr).
    The port computes on the CPU, as asked by ``--*.device=cpu``."""
    if pkg == "torch":
        args = (*args, "--*.device=cpu")
    logging = importlib.import_module(f"{PACKAGES[pkg]}.utils.logging")
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            got = tool_class(pkg, module).main(list(args))
    finally:
        os.chdir(old)
        manager = logging.LogManager.get()
        if manager._jsonl is not None:  # a run's log file ends with the run
            manager._jsonl.close()
            manager._jsonl = None
    assert got == rc, f"{pkg} {module} returned {got}:\n{out.getvalue()}\n{err.getvalue()}"
    return out.getvalue(), err.getvalue()


def both(module, *args, dirs):
    """The same tool run on both packages, each in its own directory."""
    return {pkg: run(pkg, module, *args, cwd=dirs[pkg])[0] for pkg in PACKAGES}


def toy_corpus(tmp):
    """The reference's toy corpus of ``tests/test_tools.py`` (2 words of 2
    tone phones, 8 recordings), its lexicon and a bigram LM, in ``tmp``."""
    from rasr_tpu_torch.corpus.audio import write_wav
    from rasr_tpu_torch.models.lm.arpa import NgramLm

    rng = np.random.default_rng(9)
    sr = 16000
    ph = {"a": 500, "b": 2000}
    words = {"AB": ["a", "b"], "BA": ["b", "a"]}

    def tone(s, d):
        t = np.arange(int(d * sr)) / sr
        return (0.3 * np.sin(2 * np.pi * ph[s] * t)).astype(np.float32)

    def sil(d):
        return (0.002 * rng.normal(size=int(d * sr))).astype(np.float32)

    xml = ['<corpus name="toy">']
    for i, ws in enumerate(TEXTS):
        audio = [sil(0.15)]
        for w in ws:
            for p in words[w]:
                audio.append(tone(p, 0.25))
            audio.append(sil(0.15))
        a = np.concatenate(audio)
        write_wav(str(tmp / f"rec{i}.wav"), a, sr)
        xml.append(
            f'<recording name="rec{i}" audio="rec{i}.wav">'
            f'<segment name="s" start="0" end="{len(a)/sr}"><orth>{" ".join(ws)}</orth>'
            f"</segment></recording>")
    xml.append("</corpus>")
    (tmp / "toy.corpus").write_text("".join(xml))
    (tmp / "lexicon.xml").write_text(LEXICON)
    NgramLm.train_from_text(TEXTS, order=2).write_arpa(str(tmp / "lm.arpa"))


def package_dirs(tmp, populate):
    """``tmp/jax`` and ``tmp/torch``, each a copy of the inputs ``populate``
    writes."""
    base = tmp / "inputs"
    base.mkdir()
    populate(base)
    dirs = {}
    for pkg in PACKAGES:
        shutil.copytree(base, tmp / pkg)
        dirs[pkg] = tmp / pkg
    return dirs


def wer_lines(text):
    return [line for line in text.splitlines() if "WER" in line]


def log_records(path):
    import json

    with open(path) as fh:
        return [json.loads(line) for line in fh]


def recognized(path):
    """segment -> recognized words, from a recognizer's JSONL log."""
    return {r["segment"]: r["recognized"] for r in log_records(path)
            if r.get("msg") == "recognized"}


def assert_mixtures_close(a_path, b_path, rtol=1e-3, atol=1e-3):
    """Two mixture-set files: equal shapes and densities, parameters close."""
    a, b = np.load(a_path), np.load(b_path)
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(a["num_densities"], b["num_densities"])
    for k in ("means", "variances", "weights"):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=k)


def archive_entries(path, pkg="torch"):
    archive = importlib.import_module(f"{PACKAGES[pkg]}.utils.archive")
    ar = archive.open_archive(str(path))
    try:
        return {k: ar.read(k) for k in ar.keys()}
    finally:
        ar.close()


def assert_lattices_close(a_path, b_path, rtol=1e-4):
    """Two lattice archives: the same segments, node and arc counts, and
    best paths (lemmas, and costs within ``rtol`` relative)."""
    from rasr_tpu_torch.lattice.flf import best_path
    from rasr_tpu_torch.lattice.lattice import Lattice

    a, b = archive_entries(a_path), archive_entries(b_path)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = Lattice.unpack(a[k]), Lattice.unpack(b[k])
        assert (x.num_nodes, len(x.arcs)) == (y.num_nodes, len(y.arcs)), k
        (cx, px), (cy, py) = best_path(x), best_path(y)
        assert [c.lemma for c in px] == [c.lemma for c in py], k
        np.testing.assert_allclose(cx, cy, rtol=rtol)
