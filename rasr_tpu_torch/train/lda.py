"""LDA estimation: class-scatter accumulation + generalized eigensolve.

Counterpart of ``rasr_tpu/train/lda.py`` (ref: the acoustic-model
trainer's scatter-matrix estimation and the LAPACK-backed solve; applied
by the linear-transform Flow node): spliced features with tied-state
labels accumulate per-class sums (``index_add_``) and the total second
moment (a float32 product without TF32) on their device; the small
generalized symmetric eigenproblem is solved on the host with scipy, and
the projection feeds the frontend's ``lda``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.linalg
import torch

from ..device import resolve_for
from ..models.nn import strict_precision
from .em import flatten_frames


@dataclasses.dataclass
class ScatterAccumulator:
    """Per-class first moments + global second moment; mergeable."""

    class_count: np.ndarray  # [C]
    class_sum: np.ndarray  # [C, D]
    total_sqsum: np.ndarray  # [D, D]

    @classmethod
    def zeros(cls, num_classes: int, dim: int) -> "ScatterAccumulator":
        return cls(
            np.zeros(num_classes, np.float64),
            np.zeros((num_classes, dim), np.float64),
            np.zeros((dim, dim), np.float64),
        )

    def merge(self, other: "ScatterAccumulator") -> "ScatterAccumulator":
        self.class_count += other.class_count
        self.class_sum += other.class_sum
        self.total_sqsum += other.total_sqsum
        return self

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, class_count=self.class_count, class_sum=self.class_sum,
            total_sqsum=self.total_sqsum,
        )

    @classmethod
    def load(cls, path: str) -> "ScatterAccumulator":
        if not path.endswith(".npz"):
            path += ".npz"
        d = np.load(path)
        return cls(d["class_count"], d["class_sum"], d["total_sqsum"])


def _scatter_stats(feats, labels, weights, num_classes):
    dev = feats.device
    xw = feats * weights[:, None]
    with strict_precision():
        sq = xw.T @ feats
    return (
        torch.zeros(num_classes, device=dev).index_add_(0, labels, weights),
        torch.zeros((num_classes, feats.shape[1]), device=dev).index_add_(0, labels, xw),
        sq,
    )


def accumulate_scatter(
    acc: ScatterAccumulator,
    feats,  # [B, T, D] or [N, D], numpy or a tensor
    labels,
    weights=None,
    device=None,
) -> ScatterAccumulator:
    """Add one batch of labelled frames, on ``device`` (the features' own
    when they are a tensor, else the card)."""
    device = resolve_for(feats, device)
    x, lab, w = flatten_frames(feats, labels, weights, device)
    c, s, q = _scatter_stats(x, lab, w, acc.class_count.shape[0])
    acc.class_count += c.cpu().numpy().astype(np.float64)
    acc.class_sum += s.cpu().numpy().astype(np.float64)
    acc.total_sqsum += q.cpu().numpy().astype(np.float64)
    return acc


def estimate_lda(
    acc: ScatterAccumulator, output_dim: int, regularization: float = 1e-6
) -> Tuple[np.ndarray, np.ndarray]:
    """Solve the generalized eigenproblem B v = lambda W v.

    Returns (lda matrix [D, output_dim], eigenvalues desc [output_dim]).
    """
    total = acc.class_count.sum()
    if total <= 0:
        raise ValueError("empty scatter accumulator")
    D = acc.class_sum.shape[1]
    g_mean = acc.class_sum.sum(0) / total
    total_scatter = acc.total_sqsum / total - np.outer(g_mean, g_mean)
    alive = acc.class_count > 0
    cm = acc.class_sum[alive] / acc.class_count[alive, None]  # class means
    dm = cm - g_mean
    between = (acc.class_count[alive, None, None] * dm[:, :, None] * dm[:, None, :]).sum(0) / total
    within = total_scatter - between
    within = within + regularization * np.eye(D) * np.trace(within) / D
    # symmetric generalized eig; eigh returns ascending
    vals, vecs = scipy.linalg.eigh(between, within)
    order = np.argsort(vals)[::-1][:output_dim]
    lda = vecs[:, order]
    # normalize projected within-class variance to 1 (standard whitening)
    norm = np.sqrt(np.einsum("dc,de,ec->c", lda, within, lda))
    lda = lda / np.maximum(norm, 1e-12)
    return lda.astype(np.float32), vals[order]
