"""The frontend's work: MFCC, segment CMVN, splice, LDA.

The spectrum is counted as a real FFT of the padded frame (2.5 N log2 N
per frame), not as the DFT product an implementation may compute; the
mel filterbank, the DCT and the LDA as the products they are.
"""

from __future__ import annotations

import math
from typing import Sequence

from . import Work


def work(num_samples: Sequence[int], num_frames: Sequence[int], cfg: dict) -> Work:
    f, sr = cfg["frontend"], cfg["sample_rate"]
    L = int(round(sr * f["frame_length_ms"] / 1000.0))
    nfft = 1 << (L - 1).bit_length()
    bins, mel, ceps = nfft // 2 + 1, f["num_mel"], f["num_cepstra"]
    din, dout = f["lda_in"], f["feat_dim"]
    N = float(sum(num_frames))
    fft = 2.5 * nfft * math.log2(nfft) + 3.0 * bins  # the FFT and the power
    products = 2.0 * (bins * mel + mel * ceps + din * dout)
    consts = bins * mel + mel * ceps + din * dout
    return Work({"fp32": N * fft, "tf32x3": N * products},
                4.0 * (sum(num_samples) + N * dout + consts))
