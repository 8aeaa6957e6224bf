"""The yardstick holds still: each cell's tiny run reproduces, bit for bit,
what the harness read before its acoustic models were found by name.

``golden_tiny.json`` was recorded on the CPU from the harness in which
``system.py`` and the jobs chose the GMM or the conformer by branches:
for each cell's tiny run (one traced run of a window of no length, so the
window holds one batch, the batches up to the statistics' batch, or no
training step, whatever the host's speed), digests of the draws and of
the drawn weights, the work counts of the window and of the traced batch,
the spans entered, and the check's values and limits. A change to the
harness that moves any of them moves the numbers of every later run.

    python -m benchmark.tests.test_harness_golden   # prints the fingerprints
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from benchmark import spec, system
from benchmark.tests.tiny import tiny_run

CELLS = ["gmm5k-decode", "conformer-decode", "conformer-train-ce", "gmm5k-align-em"]
GOLDEN = Path(__file__).with_name("golden_tiny.json")


def digest(*parts) -> str:
    """sha256 of arrays (dtype, shape and bytes) and JSON-able values, in order."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, torch.Tensor):
            p = p.detach().cpu().numpy()
        if isinstance(p, np.ndarray):
            h.update(f"{p.dtype}{p.shape}".encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(json.dumps(p, default=str).encode())
    return h.hexdigest()


def _work(w) -> dict:
    return {"flop": dict(sorted(w.flop.items())), "nbytes": w.nbytes}


def fingerprint(cell: str) -> dict:
    r = tiny_run(cell, seconds=0.0, trace=True)
    cfg = r.cfg
    d = system.draw(cfg, r.seed)
    weights = spec.model(cfg).weights(cfg, r.seed, r.device)
    out = spec.job(r).run(r)
    layer = out["layer"]
    return {
        "draws": {
            "lexicon": digest(d.phones, d.words),
            "lm": digest(sorted(d.vocab.items()), sorted(d.ngrams.items())),
            "acoustic": digest(*(x for k in sorted(d.acoustic) for x in (k, d.acoustic[k]))),
            "lda": digest(d.lda),
        },
        "weights": None if weights is None else digest(*(x for kv in weights.items() for x in kv)),
        "window_work": {job: _work(w) for job, (w, _) in layer["window"].items()},
        "work": {span: _work(w) for span, w in layer.get("work", {}).items()},
        "steps": layer["steps"],
        "spans": {name: s.calls for name, s in sorted(layer["summary"].spans.items())},
        "attempted": out["attempted"],
        "failed": out["failed"],
        "check": {k: [v, lim] for k, (v, lim) in out["check"].items()},
    }


@pytest.fixture
def one_thread():
    """Sums in one fixed order, so that the check's values repeat exactly:
    torch and the BLAS under numpy on one thread each (OpenBLAS on two
    threads rounds the reference frontend's products otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_the_tiny_run_reads_what_it_read(cell, one_thread):
    want = json.loads(GOLDEN.read_text())["cells"][cell]
    assert json.loads(json.dumps(fingerprint(cell))) == want


if __name__ == "__main__":
    torch.set_num_threads(1)
    with threadpool_limits(1):
        json.dump({c: fingerprint(c) for c in CELLS}, sys.stdout, indent=1)
