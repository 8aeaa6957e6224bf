"""The port's CUDA kernels against their plain versions, on the card.

The tests marked ``cuda`` need an NVIDIA card and skip without one. This
file imports no jax, so on the card's machine (which has none) it runs
without the repository's conftest:

    python -m pytest --noconftest -o addopts= -p no:cacheprovider tests/test_torch_cuda.py

The unmarked tests check what holds without a card: the smoke script
and ``cuda_device`` refuse to carry on on the CPU.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from rasr_tpu_torch import _build  # noqa: E402
from rasr_tpu_torch.device import cuda_device  # noqa: E402
from rasr_tpu_torch.models.gmm import MixtureSet, make_scoring_tensors  # noqa: E402
from rasr_tpu_torch.ops.frontend import (  # noqa: E402
    FrontendConfig, frame_signal, make_params, num_frames, preemphasize,
)
from rasr_tpu_torch.ops.kernels.gmm import gmm_scores, gmm_scores_plain  # noqa: E402
from rasr_tpu_torch.ops.kernels.mfcc import (  # noqa: E402
    folded_bases, mfcc_frames, mfcc_frames_plain,
)
from rasr_tpu_torch.search.decoder import BeamConfig  # noqa: E402
from rasr_tpu_torch.synthetic import build_setup  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cuda_device()


def _mixtures(rng, M, K, D):
    ms = MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 1.0 / K, np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    ms.num_densities[3] = 1
    ms.weights[3] = np.eye(1, K, dtype=np.float32)[0]
    return ms


@pytest.mark.cuda
@pytest.mark.parametrize("max_approx", [True, False])
@pytest.mark.parametrize("N,M,K,D", [(1000, 70, 3, 45), (5, 13, 2, 9), (300, 129, 8, 17)])
def test_gmm_kernel_matches_plain(card, max_approx, N, M, K, D):
    """Ragged frame / mixture / feature edges; fp32 sums in another order."""
    rng = np.random.default_rng(N + M)
    st = make_scoring_tensors(_mixtures(rng, M, K, D), device=card)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(card)
    before = gmm_scores.launches
    got = gmm_scores(x, st, max_approx)
    torch.cuda.synchronize()
    assert gmm_scores.launches == before + 1
    torch.testing.assert_close(got, gmm_scores_plain(x, st, max_approx), rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,fft", [(3, 16000, 0), (1, 1200, 0), (2, 4321, 1024)])
def test_mfcc_kernel_matches_plain(card, B, S, fft):
    """Strided frame views of the signal, frame counts off the tile, and
    more bins than one thread block has threads (1024-point FFT)."""
    cfg = FrontendConfig(fft_size=fft)
    p = make_params(cfg, card)
    cosw, sinw = folded_bases(p)
    rng = np.random.default_rng(S)
    sig = torch.from_numpy((rng.normal(size=(B, S)) * 0.1).astype(np.float32)).to(card)
    frames = frame_signal(preemphasize(sig, cfg.preemphasis), num_frames(S, cfg), cfg)
    got = mfcc_frames(frames, cosw, sinw, p.mel, p.dct, cfg.log_floor)
    want = mfcc_frames_plain(frames, cosw, sinw, p.mel, p.dct, cfg.log_floor)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    flat = mfcc_frames(frames.reshape(-1, cfg.frame_length).contiguous(), cosw, sinw,
                       p.mel, p.dct, cfg.log_floor)
    torch.testing.assert_close(flat.reshape(got.shape), got, rtol=0, atol=0)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    rng = np.random.default_rng(0)
    st = make_scoring_tensors(_mixtures(rng, 8, 2, 5), device=card)
    x = torch.zeros((4, 5), device=card)
    with pytest.raises(TypeError):
        gmm_scores(x.double(), st)
    with pytest.raises(ValueError):
        gmm_scores(torch.zeros((4, 6), device=card), st)
    with pytest.raises(ValueError):
        gmm_scores(torch.zeros((5, 4), device=card).T, st)
    cfg = FrontendConfig()
    p = make_params(cfg, card)
    cosw, sinw = folded_bases(p)
    with pytest.raises(ValueError):
        mfcc_frames(torch.zeros((2, 399), device=card), cosw, sinw, p.mel, p.dct, 1e-10)


@pytest.mark.cuda
def test_slice_on_card_equals_cpu(card):
    beam = BeamConfig(max_hyps=64, word_end_limit=16, root_hyps=4, branch_hyps=16,
                      lm_scale=10.0)
    kw = dict(num_words=80, num_phones=12, num_classes=150, densities=4, beam=beam)
    on_card, on_cpu = build_setup(device=card, **kw), build_setup(**kw)
    x = torch.from_numpy((np.random.default_rng(3).normal(size=(3, 12000)) * 0.1)
                         .astype(np.float32))
    lengths = torch.tensor([12000, 9000, 5000])
    f_card, n_card = on_card.frontend(x.to(card), lengths.to(card))
    f_cpu, n_cpu = on_cpu.frontend(x, lengths)
    torch.testing.assert_close(f_card.cpu(), f_cpu, rtol=1e-3, atol=1e-3)
    e_card = on_card.scorer(f_card)
    torch.testing.assert_close(e_card.cpu(), on_cpu.scorer(f_cpu), rtol=1e-4, atol=1e-2)
    a = on_card.decoder.decode_scores(e_card, n_card)
    b = on_cpu.decoder.decode_scores(e_card.cpu(), n_cpu)
    assert [r.words for r in a] == [r.words for r in b]
    np.testing.assert_allclose([r.score for r in a], [r.score for r in b], rtol=1e-5)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card: exit non-zero and print no result. Alone in a directory
    (no port beside it): the same, card or not."""
    runs = [tmp_path]
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    if not torch.cuda.is_available():
        runs.append(REPO)
    for cwd in runs:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_cuda_device_and_build_errors():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cuda_device()
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "gmm_scores")
    _build.check(0, "gmm_scores")
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path == _build.library_path()
    assert {s.name for s in _build._sources()} == {"gmm_fused.cu", "mfcc_fused.cu"}
