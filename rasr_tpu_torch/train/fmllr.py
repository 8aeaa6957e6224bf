"""Per-speaker CMLLR / fMLLR feature-space adaptation, in PyTorch.

Counterpart of ``rasr_tpu/train/fmllr.py`` (ref: the affine
feature-transform adaptation of src/Mm/ and src/Speech/, the
constrained-MLLR transforms behind RASR's speaker-adaptive recipes):
estimate, per speaker, an affine feature transform ``y = A x + b``
maximizing the aligned-GMM log likelihood

    sum_t [ log |det A| + log p(A x_t + b | m_t) ]

with the row-iterative solution for diagonal covariances (Gales 1998).
The only O(T) work, the per-row statistics

    G_i = sum_t c_{t,i} xi_t xi_t^T      c_{t,i} = sum_k gamma_{t,k} / sigma^2_{m_t,k,i}
    k_i = sum_t a_{t,i} xi_t             a_{t,i} = sum_k gamma_{t,k} mu_{m_t,k,i} / sigma^2_{m_t,k,i}

(xi = [x; 1], gamma = within-mixture density posteriors of the aligned
mixture m_t), runs as row gathers and einsums on the features' device,
in float32 without TF32 (the reference's ``Precision.HIGHEST``); the row
updates are tiny (D+1)^2 host numpy solves. A recognizer applies the
transforms per utterance as one batched ``[B, D, D]`` product
(:func:`transform_batch`).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve, resolve_for
from ..models.gmm import MixtureSet
from ..models.nn import strict_precision

BIG = 1.0e30


@dataclasses.dataclass(frozen=True)
class FmllrModelTensors:
    """The per-density parameters the statistics need, on a device."""

    means: torch.Tensor  # [M, K, D]
    inv_var: torch.Tensor  # [M, K, D]
    log_norm: torch.Tensor  # [M, K]; -BIG on padding densities

    @classmethod
    def from_mixture_set(cls, ms: MixtureSet, var_floor: float = 1e-4, device=None
                         ) -> "FmllrModelTensors":
        var = np.maximum(ms.variances, var_floor).astype(np.float64)
        mask = ms.density_mask
        with np.errstate(divide="ignore"):
            log_w = np.where(mask, np.log(np.maximum(ms.weights, 1e-37)), -BIG)
        log_norm = log_w - 0.5 * (ms.dim * math.log(2.0 * math.pi) + np.log(var).sum(-1))
        log_norm = np.where(mask, log_norm, -BIG)
        device = resolve(device)
        return cls(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                     for a in (ms.means, 1.0 / var, log_norm)))


def _model_tensors(model, device) -> FmllrModelTensors:
    if isinstance(model, FmllrModelTensors):
        return FmllrModelTensors(*(t.to(device) for t in (model.means, model.inv_var,
                                                         model.log_norm)))
    return FmllrModelTensors.from_mixture_set(model, device=device)


def density_posteriors(x, mix, valid, mt: FmllrModelTensors):
    """Within-mixture density posteriors ``[N, K]`` of frames ``x`` ``[N, D]``
    in their aligned mixtures ``mix`` (zero on invalid frames), with the
    gathered means and inverse variances ``[N, K, D]``."""
    mu = mt.means[mix]  # [N, K, D] row gather
    iv = mt.inv_var[mix]
    diff = x[:, None, :] - mu
    ll = mt.log_norm[mix] - 0.5 * torch.sum(diff * diff * iv, dim=-1)  # [N, K]
    return torch.softmax(ll, dim=-1) * valid[:, None].to(torch.float32), mu, iv


def _frames(feats, mix_ids, valid, device):
    x = torch.as_tensor(feats, device=device, dtype=torch.float32)
    mix = torch.as_tensor(np.asarray(mix_ids) if not isinstance(mix_ids, torch.Tensor)
                          else mix_ids, device=device).to(torch.int64)
    valid = (torch.ones(x.shape[0], dtype=torch.bool, device=device) if valid is None
             else torch.as_tensor(valid, device=device).to(torch.bool))
    return x, mix, valid


def fmllr_stats(
    feats,  # [N, D] valid frames (flattened over a speaker), numpy or a tensor
    mix_ids,  # [N] aligned mixture (tied-state) per frame
    model: "MixtureSet | FmllrModelTensors",
    valid=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Accumulate the fMLLR statistics (G, k, beta) for one speaker on
    ``device`` (the features' own when they are a tensor, else the card).

    Calls are additive: sum G / k / beta across batches.
    """
    device = resolve_for(feats, device)
    x, mix, valid = _frames(feats, mix_ids, valid, device)
    gamma, mu, iv = density_posteriors(x, mix, valid, _model_tensors(model, device))
    xi = torch.cat([x, torch.ones((x.shape[0], 1), device=device)], dim=-1)
    with strict_precision():
        c = torch.einsum("nk,nki->ni", gamma, iv)  # [N, D]
        a = torch.einsum("nk,nki->ni", gamma, mu * iv)  # [N, D]
        G = torch.einsum("ni,nd,ne->ide", c, xi, xi)
        k = torch.einsum("ni,nd->id", a, xi)
    beta = valid.to(torch.float32).sum()
    return (G.cpu().numpy().astype(np.float64), k.cpu().numpy().astype(np.float64),
            float(beta))


def estimate_fmllr(
    G: np.ndarray,  # [D, D+1, D+1]
    k: np.ndarray,  # [D, D+1]
    beta: float,
    iterations: int = 20,
    min_count: float = 200.0,
) -> np.ndarray:
    """Row-iterative CMLLR solve -> W = [A | b], shape [D, D+1].

    Falls back to identity when the speaker has fewer than ``min_count``
    frames (the reference's minimum-observation guard).
    """
    D = k.shape[0]
    W = np.hstack([np.eye(D), np.zeros((D, 1))])
    if beta < max(min_count, D + 1):
        return W
    # ridge keeps G_i invertible for thin speakers
    ridge = 1e-6 * np.trace(G.sum(0)) / (D * (D + 1))
    Ginv = np.linalg.inv(G + ridge * np.eye(D + 1))
    for _ in range(iterations):
        for i in range(D):
            A = W[:, :D]
            cof = np.linalg.det(A) * np.linalg.inv(A).T  # cofactor matrix
            p = np.append(cof[i], 0.0)  # [D+1] (bias has no det role)
            m1 = float(p @ Ginv[i] @ p)
            m2 = float(p @ Ginv[i] @ k[i])
            if m1 <= 0.0:
                continue
            r = math.sqrt(m2 * m2 + 4.0 * m1 * beta)
            best_q, best_w = -np.inf, None
            for alpha in ((-m2 + r) / (2 * m1), (-m2 - r) / (2 * m1)):
                w = Ginv[i] @ (k[i] + alpha * p)
                det_term = float(w @ p)
                if det_term == 0.0:
                    continue
                q = (beta * math.log(abs(det_term))
                     - 0.5 * float(w @ G[i] @ w) + float(w @ k[i]))
                if q > best_q:
                    best_q, best_w = q, w
            if best_w is not None:
                W[i] = best_w
    return W


def apply_fmllr(feats: np.ndarray, W: np.ndarray) -> np.ndarray:
    """[..., D] features -> [..., D] transformed (y = A x + b)."""
    A, b = W[:, :-1], W[:, -1]
    return feats @ A.T + b


def transform_batch(feats: torch.Tensor, segments, table: Dict[str, np.ndarray]
                    ) -> torch.Tensor:
    """Each row of ``feats`` ``[B, T, D]`` through its segment's speaker
    transform, on the features' device: one batched product with
    :func:`batch_transform_tensors`' ``(A, b)`` (identity where a speaker
    has none), in float32 without TF32."""
    A, b = batch_transform_tensors(segments, table, int(feats.shape[-1]))
    A, b = (torch.from_numpy(a).to(feats.device) for a in (A, b))
    with strict_precision():
        return torch.einsum("btd,bed->bte", feats.to(torch.float32), A) + b[:, None, :]


def apply_speaker_transforms(
    feats: np.ndarray,  # [B, T, D] padded batch
    segments,  # batch segments (carry .speaker)
    table: Dict[str, np.ndarray],
) -> np.ndarray:
    """Apply each row's speaker transform (key "*" = default; speakers
    without a transform pass through). Host-side — adaptation is a
    per-utterance affine, not worth a device round trip on its own."""
    out = np.array(np.asarray(feats), copy=True)
    default = table.get("*")
    for i, seg in enumerate(segments):
        W = table.get(getattr(seg, "speaker", None) or "", default)
        if W is None:
            continue
        out[i] = out[i] @ W[:, :-1].T + W[:, -1]
    return out.astype(np.float32)


def batch_transform_tensors(
    segments, table: Dict[str, np.ndarray], dim: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (A [B, D, D], b [B, D]) with identity where a segment's
    speaker has no transform — the device-side application form
    (feats @ A^T + b as one batched einsum; avoids the host round trip
    of apply_speaker_transforms inside decode loops)."""
    B = len(segments)
    A = np.tile(np.eye(dim, dtype=np.float32), (B, 1, 1))
    b = np.zeros((B, dim), np.float32)
    default = table.get("*")
    for i, seg in enumerate(segments):
        W = table.get(getattr(seg, "speaker", None) or "", default)
        if W is None:
            continue
        A[i] = W[:, :-1]
        b[i] = W[:, -1]
    return A, b


def fmllr_auxiliary(G: np.ndarray, k: np.ndarray, beta: float,
                    W: np.ndarray) -> float:
    """The CMLLR auxiliary objective (up to a W-independent constant):
    beta log|det A| - 0.5 sum_i w_i G_i w_i^T + sum_i w_i k_i^T.
    Monotonically non-decreasing over estimate_fmllr iterations."""
    A = W[:, :-1]
    q = beta * math.log(abs(np.linalg.det(A)))
    for i in range(k.shape[0]):
        q += -0.5 * float(W[i] @ G[i] @ W[i]) + float(W[i] @ k[i])
    return q


# ------------------------------------------------------------------ artifacts
def save_transforms(path: str, table: Dict[str, np.ndarray]) -> None:
    """JSON artifact {speaker: W rows} (key "*" = default), the
    feature-space analog of the VTLN warp table."""
    with open(path, "w") as fh:
        json.dump({spk: np.asarray(W).tolist() for spk, W in table.items()}, fh)


def load_transforms(path: str) -> Dict[str, np.ndarray]:
    with open(path) as fh:
        raw = json.load(fh)
    return {spk: np.asarray(W, np.float64) for spk, W in raw.items()}
