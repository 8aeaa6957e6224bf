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

from ..device import resolve
from ..ops.kernels.tf32 import tf32_split

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


#: the fused kernel's depth chunk: one TMA box row (``csrc/gmm_fused.cu``)
DEPTH_CHUNK = 32


def operand_shape(D: int, M: int, K: int):
    """Shape of :func:`pack_operand`'s result: ``(2, K, M, P)`` for depth
    ``P = round_up(2 D, 32)``."""
    return (2, K, M, -(-2 * D // DEPTH_CHUNK) * DEPTH_CHUNK)


def pack_operand(a: torch.Tensor, b: torch.Tensor, M: int, K: int) -> torch.Tensor:
    """The fused kernel's B operand, laid out once: ``[a; b]`` of every
    density, K-major (the depth contiguous) as TF32 ``wgmma`` takes it,
    split into TF32 hi and lo planes.

    The result is ``[2, K, M, P]``: ``op[0, k, m, p] + op[1, k, m, p]``
    (hi + lo) is ``a[p, m K + k]`` for ``p < D``, ``b[p - D, m K + k]`` for
    ``D <= p < 2 D`` and 0 up to ``P = round_up(2 D, 32)``. The kernel's TMA
    cuts it in boxes of 32 deep x 128 mixtures x both planes of one
    density and swizzles them on the way into shared memory; mixtures past
    M read as zero there, so none are stored."""
    D = a.shape[0]
    P = operand_shape(D, M, K)[-1]
    w = torch.zeros((K, M, P), dtype=torch.float32, device=a.device)
    w[:, :, :D] = a.reshape(D, M, K).permute(2, 1, 0)
    w[:, :, D:2 * D] = b.reshape(D, M, K).permute(2, 1, 0)
    return torch.stack(tf32_split(w)).contiguous()


@dataclasses.dataclass(frozen=True)
class ScoringTensors:
    """Precomputed scoring constants: a, b ``[D, M*K]`` (m-major), c
    ``[M*K]`` with +PAD_SCORE on padding densities.

    The fused kernel reads ``c`` k-major (``c_k [K, M]``) and ``[a; b]``
    as the tensor-core operand of :func:`pack_operand`; both are
    laid out once here, not per call."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    num_mixtures: int
    max_densities: int
    operand: torch.Tensor = dataclasses.field(init=False, repr=False)
    c_k: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        M, K = self.num_mixtures, self.max_densities
        object.__setattr__(self, "operand", pack_operand(self.a, self.b, M, K))
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
    ms: MixtureSet, var_floor: float = 1e-4, device=None
) -> ScoringTensors:
    device = resolve(device)
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


def mixture_posteriors(feats: torch.Tensor, st: ScoringTensors):
    """Per-density posteriors within each mixture (for EM): (gamma
    ``[..., M, K]``, exact mixture scores ``[..., M]``)."""
    d = density_scores(feats, st)
    d = d.reshape(*d.shape[:-1], st.num_mixtures, st.max_densities)
    total = -torch.logsumexp(-d, dim=-1, keepdim=True)
    gamma = torch.exp(total - d)  # exp(-(d - total))
    return gamma, total[..., 0]
