"""Diagonal GMMs scored by their best density (max approximation), the
port's ``GmmFeatureScorer``. It has no network, so the train job refuses
it; its mixtures take the align job's EM statistics."""

from __future__ import annotations

import numpy as np

from ..counts import gmm as counts
from ..reference import gmm as reference


def draw(cfg: dict, rng, M: int, D: int) -> dict:
    """Means, then variances, from ``rng``; the uniform weights take no draws."""
    K = cfg["gmm"]["densities"]
    return {
        "means": rng.normal(size=(M, K, D)).astype(np.float32),
        "variances": (0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        "weights": np.full((M, K), 1.0 / K, np.float32),
    }


def weights(cfg: dict, seed: int, device) -> None:
    """None: the draws are the whole model."""
    return None


def tiny(cfg: dict) -> None:
    """Nothing to cut: the GMM's classes are the tying's."""


def mixtures(cfg: dict, draws):
    from rasr_tpu_torch.models.gmm import MixtureSet

    g = draws.acoustic
    M, K, _ = g["means"].shape
    return MixtureSet(means=g["means"], variances=g["variances"], weights=g["weights"],
                      num_densities=np.full(M, K, np.int32))


def scorer(cfg: dict, draws, weights, device):
    from rasr_tpu_torch.models.scorer import GmmFeatureScorer

    g = cfg["gmm"]
    return GmmFeatureScorer(mixtures(cfg, draws), scale=g["scale"], max_approx=True,
                            var_floor=g["var_floor"], device=device)


def forward_work(frames, cfg: dict):
    return counts.work(int(sum(frames)), cfg)


def reference_scores(feats, draws, weights, cfg: dict, quant=None):
    if quant is None:
        return reference.scores(feats, draws.acoustic, cfg["gmm"]["var_floor"])
    return reference.scores_lowered(feats, draws.acoustic, cfg["gmm"]["var_floor"], quant)
