"""The port runs where there is no JAX (the situation on the card's machine).

A subprocess makes ``jax`` and the JAX package ``rasr_tpu`` unimportable,
imports every module of ``rasr_tpu_torch`` and drives a tiny decode slice
on the CPU, on the within-word tree, on the across-word network with 4
context groups, bigram lookahead and compact branch slots, and behind a
small conformer hybrid scorer; each decode is also streamed in blocks. A
second subprocess runs the offline recognizer over a synthesized corpus
with a lattice archive and a CTM file, and the benchmark entry point at a
tiny size. The port carries its own copies of the host modules, so it
loads no module of ``rasr_tpu``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["rasr_tpu"] = None  # and so does any import of the JAX package
import numpy as np, torch
import rasr_tpu_torch
for m in pkgutil.walk_packages(rasr_tpu_torch.__path__, "rasr_tpu_torch."):
    importlib.import_module(m.name)
from rasr_tpu_torch.search.decoder import BeamConfig
from rasr_tpu_torch.search.streaming import StreamingDecoder
from rasr_tpu_torch.synthetic import PATHS, build_setup
beam = BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8, lm_scale=10.0)
x = torch.from_numpy((np.random.default_rng(0).normal(size=(2, 8000)) * 0.1)
                     .astype(np.float32))
conformer = dict(d_model=16, num_blocks=1, num_heads=2, ff_mult=2, conv_kernel=3)
for knobs in ({}, dict(PATHS["across-word"], branch_width=40),
              dict(PATHS["conformer"], conformer=conformer)):
    s = build_setup(num_words=30, num_phones=8, num_classes=50, densities=2, beam=beam,
                    device="cpu", **knobs)
    assert (s.bigram_la is not None) == ("across_word" in knobs)
    feats, n = s.frontend(x, torch.tensor([8000, 6000]))
    e = s.scorer(feats, lengths=n)
    res = s.decoder.results_from_device(s.decoder.decode_scores_device(e, n))
    assert len(res) == 2 and all(np.isfinite(r.score) and r.words for r in res), res
    sd = StreamingDecoder(s.decoder).restart(2, n)
    for lo in range(0, e.shape[1], 16):
        sd.feed(e[:, lo:lo + 16])
    assert [r.words for r in sd.finalize()] == [r.words for r in res]
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("rasr_tpu."))))
"""

def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("LOADED")]
    assert line.split()[1:] == [], line  # no module of rasr_tpu


RECOGNIZER_SCRIPT = r"""
import io, json, os, sys, tempfile
sys.modules["jax"] = None
sys.modules["rasr_tpu"] = None
import numpy as np
from rasr_tpu_torch import bench
from rasr_tpu_torch.corpus.audio import write_wav
from rasr_tpu_torch.corpus.bliss import CorpusDescription
from rasr_tpu_torch.lattice.lattice import Lattice
from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
from rasr_tpu_torch.pipeline.visitor import CorpusVisitor
from rasr_tpu_torch.search.decoder import BeamConfig
from rasr_tpu_torch.synthetic import build_setup
from rasr_tpu_torch.utils.archive import FileArchive
beam = BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8, lm_scale=10.0)
s = build_setup(num_words=30, num_phones=8, num_classes=50, densities=2, beam=beam, device="cpu")
rng = np.random.default_rng(0)
words = [l.primary_orth for l in s.lexicon.lemmata if not l.special]
tmp = tempfile.mkdtemp()
xml = ['<corpus name="c">']
for i in range(3):
    write_wav(f"{tmp}/r{i}.wav", (rng.normal(size=8000 + 2000 * i) * 0.1).astype(np.float32))
    orth = " ".join(rng.choice(words, size=2))
    xml.append(f'<recording name="r{i}" audio="{tmp}/r{i}.wav"><segment name="s">'
               f'<orth>{orth}</orth></segment></recording>')
(open(f"{tmp}/c.corpus", "w")).write("".join(xml) + "</corpus>")
rec = OfflineRecognizer(s.frontend, s.scorer, s.decoder, lattice_archive=f"{tmp}/lat",
                        ctm_file=f"{tmp}/ctm")
results = rec.run(CorpusVisitor(CorpusDescription.load(f"{tmp}/c.corpus"), batch_size=2))
assert len(results) == 3 and rec.evaluator.report()["ref_len"] == 6
with FileArchive(f"{tmp}/lat", "r") as ar:
    assert sorted(ar.keys()) == sorted(r.segment_name for r in results)
    assert all(Lattice.unpack(ar.read(k)).num_nodes >= 1 for k in ar.keys())
out = io.StringIO()
bench.run(device="cpu", out=out, words=30, classes=50, batch=2, audio_s=1.0, iters=1, windows=1,
          max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8)
assert json.loads(out.getvalue())["metric"] == "torch_decode_throughput"
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("rasr_tpu."))))
"""


def test_recognizer_and_bench_run_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", RECOGNIZER_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("LOADED")]
    assert line.split()[1:] == [], line


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax():
    files = sorted((REPO / "rasr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "rasr_tpu"), (path, name)
