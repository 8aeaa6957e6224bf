"""Discriminative GMM training: lattice-based MMI with EBW updates.

Re-implements the reference's discriminative training modules
(ref: src/Mm/EbwDiscriminativeMixtureSetEstimator [MODULE_MM_DT],
src/Speech/*Ebw* lattice-based MMI/MPE accumulation [MODULE_SPEECH_DT]):
numerator statistics come from the forced alignment of the reference
transcription, denominator statistics from the recognition lattice —
each lattice arc contributes its word's frames weighted by the arc
posterior — and the model updates with the extended Baum-Welch formulas
with per-density smoothing.

The port's copy of ``rasr_tpu/train/discriminative.py``: the statistics
are taken by the port's ``train/em.py::accumulate`` on the device of the
aligner's scorer (the card unless it was built for another) for the
lattice accumulators, and on ``device`` (the card when None and the
features are not a tensor) for the numerator; the EBW update is host
numpy, as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..align.aligner import BatchAligner
from ..align.graph import build_linear_graph
from ..lattice.flf import forward_backward
from ..lattice.lattice import Lattice
from ..models.gmm import MixtureSet
from .em import GmmAccumulator, accumulate


@dataclasses.dataclass
class MmiAccumulators:
    num: GmmAccumulator
    den: GmmAccumulator

    @classmethod
    def zeros(cls, M: int, K: int, D: int) -> "MmiAccumulators":
        return cls(GmmAccumulator.zeros(M, K, D), GmmAccumulator.zeros(M, K, D))

    def merge(self, other: "MmiAccumulators") -> "MmiAccumulators":
        self.num.merge(other.num)
        self.den.merge(other.den)
        return self


def accumulate_numerator(
    acc: MmiAccumulators,
    model: MixtureSet,
    feats: np.ndarray,  # [B, T, D]
    labels: np.ndarray,  # [B, T] from forced alignment of the reference
    weights: Optional[np.ndarray] = None,
    device=None,
) -> None:
    accumulate(acc.num, model, feats, labels, weights, device=device)


def accumulate_denominator_from_lattice(
    acc: MmiAccumulators,
    model: MixtureSet,
    feats: np.ndarray,  # [T, D] one utterance
    lattice: Lattice,
    aligner: BatchAligner,
    lexicon,
    tying,
    topology,
    transitions,
    am_scale: float = 1.0,
    lm_scale: float = 1.0,
    min_posterior: float = 1e-3,
) -> None:
    """Per-arc posterior-weighted statistics.

    Each lattice arc spans [start_frame, end_frame); its word is forced-
    aligned over that span and every frame contributes with the arc
    posterior as weight (the reference's lattice-based EBW accumulation).
    """
    total, post = forward_backward(lattice, am_scale, lm_scale)
    spans, graphs, posts = [], [], []
    for ai, arc in enumerate(lattice.arcs):
        p = float(post[ai])
        if p < min_posterior or arc.lemma < 0:
            continue
        orth = lattice.lemma_orths[arc.lemma]
        lo = int(lattice.node_time[arc.from_node])
        hi = int(lattice.node_time[arc.to_node])
        if hi <= lo:
            continue
        try:
            g = build_linear_graph(
                orth, lexicon, tying, topology, transitions, optional_silence=False
            )
        except Exception:
            continue
        if g.num_states > hi - lo:
            continue
        spans.append((lo, hi))
        graphs.append(g)
        posts.append(p)
    if not graphs:
        return
    T_max = max(hi - lo for lo, hi in spans)
    D = feats.shape[-1]
    batch = np.zeros((len(graphs), T_max, D), np.float32)
    n_frames = np.zeros(len(graphs), np.int32)
    for i, (lo, hi) in enumerate(spans):
        batch[i, : hi - lo] = feats[lo:hi]
        n_frames[i] = hi - lo
    scores = aligner.scorer(batch)
    als = aligner.align_scores(scores, graphs, n_frames)
    labels = np.full((len(graphs), T_max), -1, np.int32)
    weights = np.zeros((len(graphs), T_max), np.float32)
    for i, al in enumerate(als):
        labels[i, : al.num_frames] = al.emission_ids
        weights[i, : al.num_frames] = posts[i]
    accumulate(acc.den, model, batch, labels, weights, device=scores.device)


def ebw_update(
    model: MixtureSet,
    acc: MmiAccumulators,
    e_constant: float = 2.0,
    min_smoothing: float = 1.0,
    variance_floor: float = 1e-3,
) -> MixtureSet:
    """Extended Baum-Welch re-estimation (ref: Mm::Ebw… estimators).

    Per density m,k with smoothing D = max(E * gamma_den, D_min iterated
    until the new variance is positive):

        mu'  = (x_num - x_den + D mu) / (g_num - g_den + D)
        var' = (x2_num - x2_den + D (var + mu^2)) / (g_num - g_den + D) - mu'^2
    """
    M, K, D_dim = model.means.shape
    new_means = model.means.copy()
    new_vars = model.variances.copy()
    new_w = model.weights.copy()
    for m in range(M):
        for k in range(int(model.num_densities[m])):
            g_num = acc.num.count[m, k]
            g_den = acc.den.count[m, k]
            if g_num + g_den <= 0:
                continue
            mu = model.means[m, k].astype(np.float64)
            var = model.variances[m, k].astype(np.float64)
            x_num, x_den = acc.num.sum[m, k], acc.den.sum[m, k]
            x2_num, x2_den = acc.num.sumsq[m, k], acc.den.sumsq[m, k]
            Dm = max(e_constant * g_den, min_smoothing)
            for _ in range(10):  # grow smoothing until variance positive
                denom = g_num - g_den + Dm
                if denom > 1e-6:
                    mu_new = (x_num - x_den + Dm * mu) / denom
                    var_new = (
                        (x2_num - x2_den + Dm * (var + mu * mu)) / denom
                        - mu_new * mu_new
                    )
                    if np.all(var_new > variance_floor):
                        break
                Dm *= 2.0
            else:
                continue  # give up on this density; keep old params
            new_means[m, k] = mu_new
            new_vars[m, k] = np.maximum(var_new, variance_floor)
        # weight update (smoothed ML over numerator counts)
        g_num_row = acc.num.count[m, : model.num_densities[m]]
        if g_num_row.sum() > 0:
            w = g_num_row / g_num_row.sum()
            new_w[m, : model.num_densities[m]] = (
                0.5 * new_w[m, : model.num_densities[m]] + 0.5 * w
            ).astype(np.float32)
            new_w[m, : model.num_densities[m]] /= new_w[m, : model.num_densities[m]].sum()
    return MixtureSet(new_means, new_vars, new_w, model.num_densities.copy())


def mmi_objective(
    num_score: float, den_score: float
) -> float:
    """-log posterior of the reference given the lattice (lower=better)."""
    return num_score - den_score


# ------------------------------------------------------------------------ MPE
def arc_accuracies(
    lattice: Lattice, ref_words: Sequence[str], ref_bounds: Sequence[Tuple[int, int]]
) -> np.ndarray:
    """Per-arc phone/word accuracy against the reference alignment
    (ref: the MPE criterion's arc accuracy; word-level approximation):
    acc(arc) = max over overlapping reference words of
               (-1 + 2*overlap) if same word else (-1 + overlap),
    the standard Povey approximation with time overlap ratios.
    """
    acc = np.full(len(lattice.arcs), -1.0)
    for ai, arc in enumerate(lattice.arcs):
        if arc.lemma < 0:
            acc[ai] = 0.0
            continue
        w = lattice.lemma_orths[arc.lemma]
        s, e = int(lattice.node_time[arc.from_node]), int(lattice.node_time[arc.to_node])
        if w.startswith("["):
            acc[ai] = 0.0  # silence-like arcs are accuracy-neutral
            continue
        best = -1.0
        for rw, (rs, re_) in zip(ref_words, ref_bounds):
            inter = max(0, min(e, re_) - max(s, rs))
            denom = max(1, re_ - rs)
            ov = inter / denom
            cand = (-1.0 + 2.0 * ov) if rw == w else (-1.0 + ov)
            best = max(best, cand)
        acc[ai] = best
    return acc


def accumulate_mpe_from_lattice(
    acc: MmiAccumulators,
    model: MixtureSet,
    feats: np.ndarray,  # [T, D]
    lattice: Lattice,
    ref_words: Sequence[str],
    ref_bounds: Sequence[Tuple[int, int]],
    aligner: BatchAligner,
    lexicon,
    tying,
    topology,
    transitions,
    am_scale: float = 1.0,
    lm_scale: float = 1.0,
    min_weight: float = 1e-3,
) -> float:
    """MPE accumulation (ref: the MPE mode of the Ebw estimators).

    Per arc: weight = posterior * (accuracy - expected_accuracy); positive
    weights accumulate as numerator statistics, negative as denominator.
    Returns the expected lattice accuracy (the MPE objective).
    """
    total, post = forward_backward(lattice, am_scale, lm_scale)
    accs = arc_accuracies(lattice, ref_words, ref_bounds)
    expected = float((post * accs).sum() / max(post.sum(), 1e-9))

    spans, graphs, weights = [], [], []
    for ai, arc in enumerate(lattice.arcs):
        w = float(post[ai]) * (float(accs[ai]) - expected)
        if abs(w) < min_weight or arc.lemma < 0:
            continue
        orth = lattice.lemma_orths[arc.lemma]
        lo = int(lattice.node_time[arc.from_node])
        hi = int(lattice.node_time[arc.to_node])
        if hi <= lo:
            continue
        try:
            g = build_linear_graph(
                orth, lexicon, tying, topology, transitions, optional_silence=False
            )
        except Exception:
            continue
        if g.num_states > hi - lo:
            continue
        spans.append((lo, hi))
        graphs.append(g)
        weights.append(w)
    if not graphs:
        return expected
    T_max = max(hi - lo for lo, hi in spans)
    D = feats.shape[-1]
    batch = np.zeros((len(graphs), T_max, D), np.float32)
    n_frames = np.zeros(len(graphs), np.int32)
    for i, (lo, hi) in enumerate(spans):
        batch[i, : hi - lo] = feats[lo:hi]
        n_frames[i] = hi - lo
    scores = aligner.scorer(batch)
    als = aligner.align_scores(scores, graphs, n_frames)
    labels = np.full((len(graphs), T_max), -1, np.int32)
    wmat = np.zeros((len(graphs), T_max), np.float32)
    for i, al in enumerate(als):
        labels[i, : al.num_frames] = al.emission_ids
        wmat[i, : al.num_frames] = abs(weights[i])
    pos = [i for i, w in enumerate(weights) if w > 0]
    neg = [i for i, w in enumerate(weights) if w < 0]
    if pos:
        accumulate(acc.num, model, batch[pos], labels[pos], wmat[pos], device=scores.device)
    if neg:
        accumulate(acc.den, model, batch[neg], labels[neg], wmat[neg], device=scores.device)
    return expected
