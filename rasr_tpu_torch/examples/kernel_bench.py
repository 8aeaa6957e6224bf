"""The GMM and MFCC kernels at the main path's shapes on one CUDA card.

Times ``gmm_scores`` (N = 64 x 998 frames of 45 dims against 2000
mixtures of 8 densities: the min and the log-sum-exp variant, and the
frontend-ext model's 51 dims) and ``mfcc_frames`` (64 x 10 s of noise at
16 kHz: 20 mel bands, 40 bands, and 21 bands and 17 outputs with the
energy column under a VTLN warp of 0.92) with CUDA events, after
checking each against its plain version with ``chip_smoke.py``'s
tolerances, and prints one JSON line tagged with the card's name and
power limit:

    python -m rasr_tpu_torch.examples.kernel_bench

It calls only what the wrappers have offered since the port's first
kernels, so a copy of it times an older checkout of the port as well:
run both checkouts in turns (older, newer, newer, older) in one session
to compare their kernels on one card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import card_tag, cuda_device, cuda_ms
from ..models.gmm import MixtureSet, make_scoring_tensors
from ..ops.frontend import FrontendConfig, frame_signal, make_params, num_frames, preemphasize
from ..ops.gammatone import piecewise_linear_warp
from ..ops.kernels.gmm import gmm_scores, gmm_scores_plain
from ..ops.kernels.mfcc import (
    folded_bases, mfcc_frames, mfcc_frames_plain, pack_basis, with_energy,
)

BATCH, SECONDS = 64, 10.0
MIXTURES, DENSITIES = 2000, 8
REPS = 10  # calls per timing
# chip_smoke.py's tolerances against the plain versions
GMM_RTOL, GMM_ATOL, MFCC_RTOL, MFCC_ATOL = 1e-5, 1e-3, 2e-4, 2e-4


def _max_err(got, want, rtol, atol, name):
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err.max().item():.3e})")
    return float(err.max())


def run(device=None) -> dict:
    dev = cuda_device() if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError("kernel_bench times the CUDA kernels: it needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    rec = {"card": card_tag()}
    cfg = FrontendConfig()
    S = int(SECONDS * cfg.sample_rate)
    T = num_frames(S, cfg)
    N = BATCH * T
    for name, D, max_approx in (("gmm", 45, True), ("gmm_lse", 45, False),
                                ("gmm_d51", 51, True)):
        ms = MixtureSet(
            means=rng.normal(size=(MIXTURES, DENSITIES, D)).astype(np.float32),
            variances=(0.5 + rng.uniform(size=(MIXTURES, DENSITIES, D))).astype(np.float32),
            weights=np.full((MIXTURES, DENSITIES), 1.0 / DENSITIES, np.float32),
            num_densities=np.full(MIXTURES, DENSITIES, np.int32),
        )
        st = make_scoring_tensors(ms, device=dev)
        x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(dev)
        rec[f"{name}_err"] = _max_err(gmm_scores(x, st, max_approx),
                                      gmm_scores_plain(x, st, max_approx), GMM_RTOL, GMM_ATOL,
                                      name)
        rec[f"{name}_ms"] = cuda_ms(lambda: gmm_scores(x, st, max_approx), REPS)
        del st, x
        torch.cuda.empty_cache()
    sig = torch.from_numpy((rng.normal(size=(BATCH, S)) * 0.1).astype(np.float32)).to(dev)
    for name, c in (("mfcc", cfg), ("mfcc_mel40", FrontendConfig(num_mel=40)),
                    ("mfcc_energy", FrontendConfig(append_energy=True))):
        p = make_params(c, dev)
        mel, dct = p.mel, p.dct
        if c.append_energy:  # the frontend-ext path's operands: VTLN-warped mel, energy band
            warp = torch.from_numpy(piecewise_linear_warp(c.num_bins, 0.92).astype(np.float32))
            mel, dct = with_energy((warp.to(dev) @ p.mel).contiguous(), p.dct)
        cosw, sinw = folded_bases(p)
        basis = pack_basis(cosw, sinw)
        frames = frame_signal(preemphasize(sig, c.preemphasis), T, c)
        args = (frames, cosw, sinw, mel, dct, c.log_floor)
        rec[f"{name}_err"] = _max_err(mfcc_frames(*args, basis), mfcc_frames_plain(*args),
                                      MFCC_RTOL, MFCC_ATOL, name)
        rec[f"{name}_ms"] = cuda_ms(lambda: mfcc_frames(*args, basis), REPS)
    rec["N"] = N
    return rec


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
