"""The port runs where there is no JAX (the situation on the card's machine).

A subprocess makes ``jax`` unimportable, imports every module of
``rasr_tpu_torch`` and drives a tiny decode slice on the CPU. The only
``rasr_tpu`` modules it may load are the JAX-free host modules.
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
import numpy as np, torch
import rasr_tpu_torch
for m in pkgutil.walk_packages(rasr_tpu_torch.__path__, "rasr_tpu_torch."):
    importlib.import_module(m.name)
from rasr_tpu_torch.search.decoder import BeamConfig
from rasr_tpu_torch.synthetic import build_setup
s = build_setup(num_words=30, num_phones=8, num_classes=50, densities=2,
                beam=BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4,
                                branch_hyps=8, lm_scale=10.0))
x = torch.from_numpy((np.random.default_rng(0).normal(size=(2, 8000)) * 0.1)
                     .astype(np.float32))
feats, n = s.frontend(x, torch.tensor([8000, 6000]))
res = s.decoder.results_from_device(s.decoder.decode_scores_device(s.scorer(feats), n))
assert len(res) == 2 and all(np.isfinite(r.score) and r.words for r in res), res
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("rasr_tpu."))))
"""

ALLOWED = {
    "rasr_tpu.corpus", "rasr_tpu.corpus.lexicon", "rasr_tpu.utils", "rasr_tpu.utils.xmlio",
    "rasr_tpu.models", "rasr_tpu.models.allophone", "rasr_tpu.models.hmm",
    "rasr_tpu.models.tying", "rasr_tpu.models.lm", "rasr_tpu.models.lm.arpa",
    "rasr_tpu.models.lm.interface",
}


def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("LOADED")]
    loaded = set(line.split()[1:])
    assert loaded <= ALLOWED, sorted(loaded - ALLOWED)


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
            assert name.split(".")[0] != "jax", (path, name)
            assert not name.startswith("rasr_tpu.ops"), (path, name)
            assert not name.startswith("rasr_tpu.search"), (path, name)
    # chip_smoke reaches the shared host modules only through the port
    assert not [n for n in _imports(REPO / "chip_smoke.py") if n.split(".")[0] == "rasr_tpu"]
