"""The 3xTF32 arithmetic of the GMM and MFCC kernels, emulated on the CPU.

The kernels split each fp32 operand into TF32 hi and lo parts (round to
nearest, low 13 mantissa bits zero) and take each product as lo*hi +
hi*lo + hi*hi with fp32 accumulation. A product of two TF32 values is
exact in fp32, so fp32 matrix products of the split planes reproduce
that arithmetic up to the order of the sums. These tests hold the result
to the kernels' plain fp32 versions within ``chip_smoke.py``'s tolerances,
at the main path's value ranges, for both GMM variants with padding
densities and for MFCC with a near-silent stretch, where the log
amplifies relative error.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import GMM_ATOL, GMM_RTOL, MFCC_ATOL, MFCC_RTOL  # noqa: E402
from rasr_tpu_torch.models.gmm import MixtureSet, make_scoring_tensors  # noqa: E402
from rasr_tpu_torch.ops.frontend import (  # noqa: E402
    FrontendConfig, frame_signal, make_params, num_frames, preemphasize,
)
from rasr_tpu_torch.ops.kernels.gmm import gmm_scores_plain  # noqa: E402
from rasr_tpu_torch.ops.kernels.mfcc import folded_bases, mfcc_frames_plain  # noqa: E402
from rasr_tpu_torch.ops.kernels.tf32 import tf32_round, tf32_split  # noqa: E402


def matmul_3xtf32(a, b):
    a_hi, a_lo = tf32_split(a.contiguous())
    b_hi, b_lo = tf32_split(b.contiguous())
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def test_tf32_round_is_nearest_with_13_low_bits_clear():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=1000) * 10.0 ** rng.integers(-8, 8, size=1000),
        [0.0, -0.0, 1.0, -3.5, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 3 * 2.0**-12)],
    ]).astype(np.float32))
    r = tf32_round(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    x64, r64 = x.double(), r.double()
    half_ulp = torch.ldexp(torch.ones_like(x64), torch.frexp(x64).exponent - 12)
    assert ((r64 - x64).abs() <= half_ulp).all()
    # ties go away from zero, as cvt.rna does
    assert r[-3].item() == 1.0 + 2.0**-10 and r[-2].item() == 1.0
    assert r[-1].item() == -(1.0 + 2.0**-10)
    hi, lo = tf32_split(x)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = ((hi.double() + lo.double()) - x64).abs()
    assert (err <= 2.0**-21 * x64.abs()).all()


@pytest.mark.parametrize("max_approx", [True, False])
def test_gmm_3xtf32_holds_the_fp32_scores(max_approx):
    """The main path's shape of model (D=45, K=8, means N(0,1), variances
    0.5-1.5 as in ``synthetic.build_setup``), fewer mixtures and frames;
    ragged density counts, so padding densities carry PAD_SCORE."""
    rng = np.random.default_rng(1)
    M, K, D, N = 150, 8, 45, 400
    ms = MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 1.0 / K, np.float32),
        num_densities=rng.integers(1, K + 1, size=M).astype(np.int32),
    )
    st = make_scoring_tensors(ms, device="cpu")
    x = torch.from_numpy((rng.normal(size=(N, D)) * rng.uniform(0.5, 3.0, size=(N, 1)))
                         .astype(np.float32))
    d = matmul_3xtf32(torch.cat([x * x, x], 1), torch.cat([st.a, st.b], 0)) + st.c
    d = d.reshape(N, M, K)
    got = d.min(-1).values if max_approx else -torch.logsumexp(-d, -1)
    want = gmm_scores_plain(x, st, max_approx)
    torch.testing.assert_close(got, want, rtol=GMM_RTOL, atol=GMM_ATOL)
    assert (ms.num_densities < K).any()


@pytest.mark.parametrize("sample_rate", [16000, 8000])
def test_mfcc_3xtf32_holds_the_fp32_cepstra(sample_rate):
    """0.1-amplitude noise as on the main path, its first half scaled to
    ~1e-3 amplitude (near silence)."""
    cfg = FrontendConfig(sample_rate=sample_rate)
    p = make_params(cfg, device="cpu")
    cosw, sinw = folded_bases(p)
    rng = np.random.default_rng(2)
    S = sample_rate
    sig = rng.normal(size=(2, S)) * 0.1
    sig[:, : S // 2] *= 0.01
    frames = frame_signal(preemphasize(torch.from_numpy(sig.astype(np.float32)),
                                       cfg.preemphasis), num_frames(S, cfg), cfg)
    re = matmul_3xtf32(frames.reshape(-1, cfg.frame_length), cosw)
    im = matmul_3xtf32(frames.reshape(-1, cfg.frame_length), sinw)
    mel = torch.clamp((re * re + im * im) @ p.mel, min=cfg.log_floor)
    got = (torch.log(mel) @ p.dct).reshape(2, -1, p.dct.shape[1])
    want = mfcc_frames_plain(frames, cosw, sinw, p.mel, p.dct, cfg.log_floor)
    torch.testing.assert_close(got, want, rtol=MFCC_RTOL, atol=MFCC_ATOL)
