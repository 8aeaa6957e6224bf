"""Model-space MLLR mean adaptation with regression classes, in PyTorch.

Counterpart of ``rasr_tpu/train/mllr.py`` (ref: the MLLR-style model
adaptation of src/Mm/ + src/Speech/, the companion of the feature-space
variant in ``train/fmllr.py``): per speaker and regression class c, find
W_c = [A_c | b_c] maximizing

    sum_{t, m in c} gamma_{t,m} log N(x_t ; W_c xi_m, Sigma_m)

with xi_m = [mu_m; 1]. For diagonal covariances each row is a weighted
least-squares problem with the closed form

    w_i = z_i G_i^{-1},   G_i = sum gamma/sigma^2_i xi xi^T,
                          z_i = sum gamma x_i/sigma^2_i xi^T

(no determinant term, no iteration). Classes below a minimum occupancy
back off to the global class. The per-mixture statistics are gathered
and summed (``index_add_``) on the features' device; the per-class
solves are host numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_for
from ..models.gmm import MixtureSet
from .fmllr import FmllrModelTensors, _frames, _model_tensors, density_posteriors


def mllr_stats(
    feats,  # [N, D] valid frames, numpy or a tensor
    mix_ids,  # [N] aligned mixture per frame
    model: "MixtureSet | FmllrModelTensors",
    valid=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(gamma [M, K], gamma-weighted x sums [M, K, D]) on ``device`` (the
    features' own when they are a tensor, else the card); additive
    across batches. Per-mixture statistics: any regression-class
    partition aggregates them later."""
    device = resolve_for(feats, device)
    x, mix, valid = _frames(feats, mix_ids, valid, device)
    mt = _model_tensors(model, device)
    gamma = density_posteriors(x, mix, valid, mt)[0]
    M, K = mt.log_norm.shape
    g = torch.zeros((M, K), device=device).index_add_(0, mix, gamma)
    gx = torch.zeros((M, K, x.shape[1]), device=device).index_add_(
        0, mix, gamma[:, :, None] * x[:, None, :])
    return g.cpu().numpy().astype(np.float64), gx.cpu().numpy().astype(np.float64)


def default_regression_classes(ms: MixtureSet, num_classes: int = 2
                               ) -> np.ndarray:
    """Flat regression-class assignment [M]: k-means-style split of the
    mixtures by their occupancy-free mean vectors (the reference grows a
    regression TREE; a flat partition is its two-level special case)."""
    M = ms.num_mixtures
    if num_classes <= 1 or M <= num_classes:
        return np.zeros(M, np.int64) if num_classes <= 1 else np.arange(M)
    mean0 = ms.means.mean(axis=1)  # [M, D]
    rng = np.random.default_rng(0)
    centers = mean0[rng.choice(M, num_classes, replace=False)]
    assign = np.zeros(M, np.int64)
    for _ in range(10):
        d = ((mean0[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for c in range(num_classes):
            sel = assign == c
            if sel.any():
                centers[c] = mean0[sel].mean(0)
    return assign


def estimate_mllr(
    g: np.ndarray,  # [M, K] occupancies
    gx: np.ndarray,  # [M, K, D] occupancy-weighted feature sums
    ms: MixtureSet,
    classes: Optional[np.ndarray] = None,  # [M] regression class per mixture
    min_count: float = 200.0,
    var_floor: float = 1e-4,
) -> Dict[int, np.ndarray]:
    """Closed-form row solves -> {class: W [D, D+1]}.

    Classes under ``min_count`` occupancy back off to the GLOBAL
    transform; if even the global count is thin, identity.
    """
    M, K, D = gx.shape
    if classes is None:
        classes = np.zeros(M, np.int64)
    var = np.maximum(ms.variances, var_floor)
    xi = np.concatenate([ms.means, np.ones((M, K, 1))], axis=-1)  # [M,K,D+1]

    def solve(sel: np.ndarray) -> Optional[np.ndarray]:
        count = g[sel].sum()
        if count < max(min_count, D + 1):
            return None
        gs, gxs = g[sel], gx[sel]  # [m,K], [m,K,D]
        xis, vs = xi[sel], var[sel]
        # G_i = sum g/sigma2_i xi xi^T ; z_i = sum gx_i/sigma2_i xi^T
        w = gs[..., None] / vs  # [m, K, D]
        G = np.einsum("mki,mkd,mke->ide", w, xis, xis)
        z = np.einsum("mki,mkd->id", gxs / vs, xis)
        W = np.zeros((D, D + 1))
        ridge = 1e-6 * np.trace(G.sum(0)) / (D * (D + 1))
        for i in range(D):
            W[i] = np.linalg.solve(G[i] + ridge * np.eye(D + 1), z[i])
        return W

    ident = np.hstack([np.eye(D), np.zeros((D, 1))])
    global_W = solve(np.ones(M, bool))
    if global_W is None:
        global_W = ident
    out: Dict[int, np.ndarray] = {}
    for c in np.unique(classes):
        W = solve(classes == c)
        out[int(c)] = W if W is not None else global_W
    return out


def adapt_means(ms: MixtureSet, transforms: Dict[int, np.ndarray],
                classes: Optional[np.ndarray] = None) -> MixtureSet:
    """Apply per-regression-class mean transforms -> adapted MixtureSet
    (variances/weights unchanged, the classic mean-MLLR update)."""
    M, K, D = ms.means.shape
    if classes is None:
        classes = np.zeros(M, np.int64)
    means = ms.means.copy()
    for c, W in transforms.items():
        sel = classes == c
        A, b = W[:, :-1], W[:, -1]
        means[sel] = ms.means[sel] @ A.T + b
    return MixtureSet(
        means.astype(ms.means.dtype), ms.variances.copy(),
        ms.weights.copy(), ms.num_densities.copy(),
    )
