"""Gaussian mixture sets with dense scoring tensors, in PyTorch.

Counterpart of ``rasr_tpu/models/gmm.py``. For diagonal Gaussians the
negative density log-likelihood is

    s_i(x) = c_i + sum_d a_{d,i} x_d^2 + sum_d b_{d,i} x_d
    a = 0.5/var,  b = -mean/var,
    c = -log w + 0.5 (D log 2pi + sum log var + sum mean^2/var)

so all densities of all mixtures score with two matrix products, then
reduce over each mixture's K densities (max-approximation or exact
log-sum-exp). :class:`MixtureSet` is the numpy host form (same fields and
``.npz`` format as the reference); :class:`ScoringTensors` holds torch
tensors in the reference's ``[D, M*K]`` m-major layout, with
``PAD_SCORE`` on padding densities.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
PAD_SCORE = 1e30  # -log score of padding densities (never wins)


@dataclasses.dataclass
class MixtureSet:
    """Canonical (host, numpy) representation of a mixture set.

    means/variances ``[M, K, D]`` padded along K; weights ``[M, K]``
    (linear, rows sum to 1 over valid densities); num_densities ``[M]``.
    """

    means: np.ndarray
    variances: np.ndarray
    weights: np.ndarray
    num_densities: np.ndarray

    def __post_init__(self):
        if self.means.shape != self.variances.shape:
            raise ValueError("means and variances differ in shape")
        if self.weights.shape != self.means.shape[:2]:
            raise ValueError("weights must be [M, K]")
        if self.num_densities.shape != (self.means.shape[0],):
            raise ValueError("num_densities must be [M]")

    @property
    def num_mixtures(self) -> int:
        return self.means.shape[0]

    @property
    def max_densities(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @property
    def total_densities(self) -> int:
        return int(self.num_densities.sum())

    @property
    def density_mask(self) -> np.ndarray:
        return np.arange(self.max_densities)[None, :] < self.num_densities[:, None]

    @classmethod
    def single_density(cls, means: np.ndarray, variances: np.ndarray) -> "MixtureSet":
        """One Gaussian per mixture (EM iteration 0)."""
        M, D = means.shape
        return cls(
            means=means[:, None, :].astype(np.float32),
            variances=variances[:, None, :].astype(np.float32),
            weights=np.ones((M, 1), np.float32),
            num_densities=np.ones(M, np.int32),
        )

    def pad_to(self, k_max: int) -> "MixtureSet":
        """Grow the density axis (identity if already >= k_max)."""
        M, K, D = self.means.shape
        if K >= k_max:
            return self
        pad = ((0, 0), (0, k_max - K), (0, 0))
        return MixtureSet(
            means=np.pad(self.means, pad),
            variances=np.pad(self.variances, pad, constant_values=1.0),
            weights=np.pad(self.weights, pad[:2]),
            num_densities=self.num_densities,
        )

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, means=self.means, variances=self.variances,
            weights=self.weights, num_densities=self.num_densities,
        )

    @classmethod
    def load(cls, path: str) -> "MixtureSet":
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        return cls(
            means=data["means"], variances=data["variances"],
            weights=data["weights"], num_densities=data["num_densities"],
        )


@dataclasses.dataclass(frozen=True)
class ScoringTensors:
    """Precomputed scoring constants: a, b ``[D, M*K]`` (m-major), c
    ``[M*K]`` with +PAD_SCORE on padding densities.

    The fused kernel reads the same constants k-major (``a_k``, ``b_k``
    ``[K, D, M]``, ``c_k`` ``[K, M]``), so each density's columns are
    contiguous; they are laid out once here, not per call."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    num_mixtures: int
    max_densities: int
    a_k: torch.Tensor = dataclasses.field(init=False, repr=False)
    b_k: torch.Tensor = dataclasses.field(init=False, repr=False)
    c_k: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        D, M, K = self.a.shape[0], self.num_mixtures, self.max_densities
        for name, t in (("a", self.a), ("b", self.b)):
            kmaj = t.reshape(D, M, K).permute(2, 0, 1).contiguous()
            object.__setattr__(self, name + "_k", kmaj)
        object.__setattr__(self, "c_k", self.c.reshape(M, K).T.contiguous())

    @property
    def dim(self) -> int:
        return self.a.shape[0]

    def to(self, device) -> "ScoringTensors":
        return ScoringTensors(
            self.a.to(device), self.b.to(device), self.c.to(device),
            self.num_mixtures, self.max_densities,
        )


def make_scoring_tensors(
    ms: MixtureSet, var_floor: float = 1e-4, device="cpu"
) -> ScoringTensors:
    M, K, D = ms.means.shape
    var = np.maximum(ms.variances, var_floor).astype(np.float64)
    mean = ms.means.astype(np.float64)
    mask = ms.density_mask
    with np.errstate(divide="ignore"):
        log_w = np.where(mask, np.log(np.maximum(ms.weights, 1e-37)), 0.0)
    a = 0.5 / var  # [M,K,D]
    b = -mean / var
    c = -log_w + 0.5 * (D * LOG_2PI + np.log(var).sum(-1) + (mean * mean / var).sum(-1))
    c = np.where(mask, c, PAD_SCORE)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)

    return ScoringTensors(
        a=dev(a.reshape(M * K, D).T),
        b=dev(b.reshape(M * K, D).T),
        c=dev(c.reshape(M * K)),
        num_mixtures=M,
        max_densities=K,
    )


def density_scores(feats: torch.Tensor, st: ScoringTensors) -> torch.Tensor:
    """[..., D] -> [..., M*K] per-density -log(w * N(x))."""
    x = feats.to(torch.float32)
    return torch.matmul(x * x, st.a) + torch.matmul(x, st.b) + st.c


def mixture_scores(
    feats: torch.Tensor, st: ScoringTensors, max_approx: bool = True
) -> torch.Tensor:
    """[..., D] -> [..., M] emission scores (-log p(x|mixture)):
    max-approximation over densities, or exact log-sum-exp. This is the
    plain version of the fused GMM kernel."""
    d = density_scores(feats, st)
    d = d.reshape(*d.shape[:-1], st.num_mixtures, st.max_densities)
    if max_approx:
        return d.min(dim=-1).values
    return -torch.logsumexp(-d, dim=-1)
