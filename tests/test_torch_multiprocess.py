"""PyTorch port vs JAX: real processes over ``torch.distributed`` (gloo).

The three cases of ``tests/test_multiprocess.py`` (``slow`` there and
here: each starts processes of its own), with the worker
``tests/torch_multiprocess_worker.py`` (port only): two ranks' DP-EM
statistics equal the JAX single-process accumulation (count 1e-4, sums
1e-4, squares 1e-3 relative, as the reference) and their counters sum;
two ranks recognize disjoint corpus partitions through
``CorpusWorkQueue`` and their WER counters, summed over the group, equal
one uninterrupted process's; a process killed after its first batch
resumes from its done archive and ends with the uninterrupted run's
hypotheses.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from rasr_tpu_torch.parallel.mesh import spawn_ranks
from tests.test_multiprocess import _build_recog_workdir

pytestmark = pytest.mark.slow  # as the reference: pytest -m "" tests/

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multiprocess_worker.py")
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _parse(out, rank=0):
    m = re.search(rf"REC-OK {rank} processed=(\d+) skipped=(\d+) err=(\d+) ref=(\d+)", out)
    assert m, out
    return tuple(int(g) for g in m.groups())


def _solo(tmp_path, tag, env=ENV):
    return subprocess.run([sys.executable, WORKER, "recog", str(tmp_path), tag], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)


def test_two_process_dp_em(tmp_path):
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.train.em import GmmAccumulator, accumulate

    spawn_ranks([sys.executable, WORKER, "em", str(tmp_path)], 2,
                "file://" + str(tmp_path / "store"), 300, ENV)
    rng = np.random.default_rng(0)
    M, K, D, N = 4, 2, 6, 64
    model = MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 0.5, np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    feats = rng.normal(size=(N, D)).astype(np.float32)
    labels = rng.integers(0, M, size=N).astype(np.int32)
    acc = GmmAccumulator.zeros(M, K, D)
    accumulate(acc, model, feats, labels)
    for r in range(2):
        out = np.load(tmp_path / f"em_r{r}.npz")
        np.testing.assert_allclose(out["count"], acc.count, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["sum"], acc.sum, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["sumsq"], acc.sumsq, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(out["wer"], [6.0, 200.0])


def test_two_process_recognition_with_psum_wer(tmp_path):
    """Two ranks decode disjoint partitions, persist their hypotheses and
    sum their WER counters over the group: every rank sees the counters of
    an uninterrupted single-process run."""
    _build_recog_workdir(tmp_path)
    solo = _solo(tmp_path, "oracle")
    assert solo.returncode == 0, solo.stdout
    done_s, skip_s, err_s, ref_s = _parse(solo.stdout)
    assert done_s == 6 and skip_s == 0
    assert err_s > 0  # the planted bad segment
    outs = spawn_ranks([sys.executable, WORKER, "recog", str(tmp_path), "mp"], 2,
                       "file://" + str(tmp_path / "store"), 300, ENV)
    done_total = 0
    for r, out in enumerate(outs):
        d, _, err, ref = _parse(out, r)
        done_total += d
        assert (err, ref) == (err_s, ref_s), (out, err_s, ref_s)
    assert done_total == 6


def test_recognition_resume_after_crash(tmp_path):
    """The worker dies after its first batch; the rerun skips what the done
    archive holds and completes the rest, which then holds exactly the
    uninterrupted run's hypotheses."""
    from rasr_tpu.corpus.bliss import CorpusDescription
    from rasr_tpu.lattice.evaluator import align_tokens
    from rasr_tpu.utils.archive import FileArchive

    _build_recog_workdir(tmp_path)
    solo = _solo(tmp_path, "oracle")
    assert solo.returncode == 0, solo.stdout
    _, _, err_s, ref_s = _parse(solo.stdout)
    p = _solo(tmp_path, "resume", dict(ENV, CRASH_AFTER_BATCHES="1"))
    assert p.returncode == 17, p.stdout
    assert "CRASHING after 1 batches" in p.stdout
    p2 = _solo(tmp_path, "resume")
    assert p2.returncode == 0, p2.stdout
    processed, skipped, _, _ = _parse(p2.stdout)
    assert skipped == 2 and processed == 4
    corpus = CorpusDescription.load(str(tmp_path / "toy.corpus"))
    total_err = total_ref = 0
    with FileArchive(str(tmp_path / "done.resume.p0.cache"), "r") as ar:
        keys = set(ar.keys())
        for seg in corpus.segments():
            assert seg.full_name in keys
            st, _ = align_tokens(seg.orth.split(), ar.read(seg.full_name).decode().split())
            total_err += st.errors
            total_ref += st.reference_length
    assert (total_err, total_ref) == (err_s, ref_s)
