"""GMM EM training: accumulate -> (merge) -> estimate -> split, in PyTorch.

Counterpart of ``rasr_tpu/train/em.py`` (ref: src/Mm/MixtureSetEstimator.*
and the accumulate / combine / estimate / split actions of the
acoustic-model trainer). Accumulation is label-based: frames carry a tied
state label (from a Viterbi or Baum-Welch alignment, with per-frame
weights), and within the labelled mixture the statistics spread over the
densities by the current model's density posteriors.

The statistics are taken on the features' device: each frame's labelled
mixture is gathered, its density posteriors computed, and the per-mixture
sums made with ``index_add_`` (the reference's ``segment_sum``; on the
card its float32 sums run in another order). The accumulator itself is
float64 numpy on the host, mergeable by addition and saved as ``.npz``
like the reference's; :func:`estimate` and :func:`split` are host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_for
from ..models.gmm import MixtureSet


@dataclasses.dataclass
class GmmAccumulator:
    """Sufficient statistics; mergeable by addition (ref: accumulator files).

    count ``[M, K]``, sum ``[M, K, D]``, sumsq ``[M, K, D]``.
    """

    count: np.ndarray
    sum: np.ndarray
    sumsq: np.ndarray

    @classmethod
    def zeros(cls, M: int, K: int, D: int) -> "GmmAccumulator":
        return cls(
            np.zeros((M, K), np.float64),
            np.zeros((M, K, D), np.float64),
            np.zeros((M, K, D), np.float64),
        )

    def merge(self, other: "GmmAccumulator") -> "GmmAccumulator":
        self.count += other.count
        self.sum += other.sum
        self.sumsq += other.sumsq
        return self

    def save(self, path: str) -> None:
        np.savez_compressed(path, count=self.count, sum=self.sum, sumsq=self.sumsq)

    @classmethod
    def load(cls, path: str) -> "GmmAccumulator":
        if not path.endswith(".npz"):
            path += ".npz"
        d = np.load(path)
        return cls(d["count"], d["sum"], d["sumsq"])

    @property
    def shape(self):
        return self.sum.shape


def flatten_frames(feats, labels, weights, device):
    """``[B, T, D]`` / ``[N, D]`` frames with labels (-1 = padding) and
    optional weights -> (feats ``[N, D]`` float32, labels ``[N]`` int64
    with padding at 0, weights ``[N]`` float32 with padding at 0), on
    ``device``."""
    feats = torch.as_tensor(feats, device=device, dtype=torch.float32)
    labels = torch.as_tensor(labels, device=device)
    feats = feats.reshape(-1, feats.shape[-1])
    labels = labels.reshape(-1).to(torch.int64)
    weights = (torch.ones(labels.shape[0], device=device) if weights is None
               else torch.as_tensor(weights, device=device, dtype=torch.float32).reshape(-1))
    valid = labels >= 0
    weights = torch.where(valid, weights, torch.zeros_like(weights))
    return feats, torch.where(valid, labels, torch.zeros_like(labels)), weights


def _accumulate_stats(feats, labels, weights, means, variances, log_weights):
    """Per-density weighted statistics via within-mixture posteriors,
    computed only for each frame's labelled mixture (a gather): O(N K D)."""
    M, K, D = means.shape
    mu = means[labels]  # [N, K, D]
    var = variances[labels]
    x = feats[:, None, :]
    ll = log_weights[labels] - 0.5 * torch.sum(torch.log(var) + (x - mu) ** 2 / var, dim=-1)
    gamma = torch.softmax(ll, dim=-1) * weights[:, None]  # [N, K]
    count = torch.zeros((M, K), device=feats.device).index_add_(0, labels, gamma)
    s1 = torch.zeros((M, K, D), device=feats.device).index_add_(
        0, labels, gamma[..., None] * x)
    s2 = torch.zeros((M, K, D), device=feats.device).index_add_(
        0, labels, gamma[..., None] * (feats ** 2)[:, None, :])
    return count, s1, s2


def accumulate(
    acc: GmmAccumulator,
    model: MixtureSet,
    feats,  # [B, T, D] or [N, D], numpy or a tensor
    labels,  # [B, T] or [N]
    weights=None,
    var_floor: float = 1e-4,
    device=None,
) -> GmmAccumulator:
    """Add one batch of aligned frames to the accumulator. The statistics
    are taken on ``device`` (the features' own when they are a tensor,
    else the card)."""
    device = resolve_for(feats, device)
    x, lab, w = flatten_frames(feats, labels, weights, device)
    mask = model.density_mask
    with np.errstate(divide="ignore"):
        lw = np.where(mask, np.log(np.maximum(model.weights, 1e-37)), -1e30)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    count, s1, s2 = _accumulate_stats(
        x, lab, w, dev(model.means), dev(np.maximum(model.variances, var_floor)), dev(lw))
    acc.count += count.cpu().numpy().astype(np.float64)
    acc.sum += s1.cpu().numpy().astype(np.float64)
    acc.sumsq += s2.cpu().numpy().astype(np.float64)
    return acc


def estimate(
    acc: GmmAccumulator,
    min_observations: float = 1.0,
    variance_floor_factor: float = 0.01,
    prev: Optional[MixtureSet] = None,
    variance_tying: str = "density",
) -> MixtureSet:
    """ML re-estimation with min-observation pruning and variance flooring.

    Densities with too few observations are dropped (their mass folds into
    the surviving densities' weight renormalization); mixtures with no
    surviving density keep their previous parameters (or a unit Gaussian).
    The variance floor is ``factor * global pooled variance`` per dim.
    ``variance_tying``: ``"density"`` = per-density diagonal (default);
    ``"mixture"`` = one diagonal covariance shared by a mixture's
    densities; ``"pooled"`` = one global diagonal covariance.
    """
    if variance_tying not in ("density", "mixture", "pooled"):
        raise ValueError(f"unknown variance_tying {variance_tying!r}")
    M, K, D = acc.shape
    count = acc.count  # [M, K]
    total = count.sum()
    if total <= 0:
        raise ValueError("empty accumulator")
    g_mean = acc.sum.sum((0, 1)) / total
    g_var = np.maximum(acc.sumsq.sum((0, 1)) / total - g_mean**2, 1e-8)
    floor = variance_floor_factor * g_var  # [D]

    alive = count >= min_observations  # [M, K]
    cnt = np.maximum(count, 1e-10)[..., None]
    means = acc.sum / cnt
    if variance_tying == "density":
        variances = np.maximum(acc.sumsq / cnt - means**2, floor[None, None, :])
    else:
        # within-density scatter (zero for unobserved densities)
        within = acc.sumsq - count[..., None] * means**2  # [M, K, D]
        if variance_tying == "pooled":
            pooled = np.maximum(within.sum((0, 1)) / total, floor)
            variances = np.broadcast_to(pooled, (M, K, D)).copy()
        else:  # mixture
            cm = np.maximum(count.sum(1), 1e-10)[:, None]
            vm = np.maximum(within.sum(1) / cm, floor[None, :])  # [M, D]
            variances = np.broadcast_to(vm[:, None, :], (M, K, D)).copy()

    # compact: move surviving densities to the front of each mixture row
    new_means = np.zeros_like(means, dtype=np.float32)
    new_vars = np.ones_like(variances, dtype=np.float32)
    new_w = np.zeros((M, K), np.float32)
    new_nd = np.zeros(M, np.int32)
    for m in range(M):
        idx = np.where(alive[m])[0]
        if idx.size == 0:
            if prev is not None:
                nd = int(prev.num_densities[m])
                new_means[m, :nd] = prev.means[m, :nd]
                new_vars[m, :nd] = prev.variances[m, :nd]
                new_w[m, :nd] = prev.weights[m, :nd]
                new_nd[m] = nd
            else:
                new_means[m, 0] = g_mean
                new_vars[m, 0] = g_var
                new_w[m, 0] = 1.0
                new_nd[m] = 1
            continue
        n = idx.size
        new_means[m, :n] = means[m, idx]
        new_vars[m, :n] = variances[m, idx]
        w = count[m, idx]
        new_w[m, :n] = (w / w.sum()).astype(np.float32)
        new_nd[m] = n
    return MixtureSet(new_means, new_vars, new_w, new_nd)


def split(
    model: MixtureSet,
    acc: Optional[GmmAccumulator] = None,
    min_split_observations: float = 2.0,
    perturbation: float = 0.2,
) -> MixtureSet:
    """Density splitting: each (sufficiently observed) density becomes two,
    perturbed +-eps*sigma along each dim (the 1 -> 2 -> 4 -> ... mixture
    growing schedule)."""
    M, K, D = model.means.shape
    K2 = K * 2
    means = np.zeros((M, K2, D), np.float32)
    variances = np.ones((M, K2, D), np.float32)
    weights = np.zeros((M, K2), np.float32)
    nd = np.zeros(M, np.int32)
    for m in range(M):
        n = int(model.num_densities[m])
        out = 0
        for k in range(n):
            c = acc.count[m, k] if acc is not None else np.inf
            sigma = np.sqrt(model.variances[m, k])
            if c >= min_split_observations:
                for sign in (+1.0, -1.0):
                    means[m, out] = model.means[m, k] + sign * perturbation * sigma
                    variances[m, out] = model.variances[m, k]
                    weights[m, out] = model.weights[m, k] / 2.0
                    out += 1
            else:
                means[m, out] = model.means[m, k]
                variances[m, out] = model.variances[m, k]
                weights[m, out] = model.weights[m, k]
                out += 1
        nd[m] = out
    k_max = max(int(nd.max()), 1)
    return MixtureSet(means[:, :k_max], variances[:, :k_max], weights[:, :k_max], nd)
