"""Diagonal-GMM scoring: every density of every class on every frame.

``4 N D M K`` operations (the products ``x^2 a + x b`` of each density),
float32-accurate; 1.84e11 at 64 x 998 frames of 45 dims and 2000 x 8
densities. Bytes: the features read, the scores written and the
parameters (a, b and a constant per density) read once.
"""

from __future__ import annotations

from . import Work


def work(num_frames: int, cfg: dict) -> Work:
    D = cfg["frontend"]["feat_dim"]
    M, K = cfg["tying"]["num_classes"], cfg["gmm"]["densities"]
    N = float(num_frames)
    return Work({"tf32x3": 4.0 * N * D * M * K}, 4.0 * (N * D + N * M + (2 * D + 1) * M * K))
