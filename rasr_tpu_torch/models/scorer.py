"""The emission-score interface ("FeatureScorer" seam), in PyTorch.

Counterpart of ``rasr_tpu/models/scorer.py``: one call scores ALL
mixtures for ALL frames of an utterance batch, features ``[B, T, D]`` ->
scores ``[B, T, M]`` (-log p, scaled). Scorers register by name like the
reference's ``feature-scorer-type`` values.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from ..ops.kernels.gmm import gmm_scores
from .gmm import MixtureSet, ScoringTensors, make_scoring_tensors


class FeatureScorer(nn.Module):
    """Batched emission scorer: features ``[B, T, D]`` -> scores ``[B, T, M]``."""

    #: number of emission classes (tied states)
    num_classes: int

    def score(self, feats: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def forward(self, feats: torch.Tensor, **kw) -> torch.Tensor:
        # length-aware scorers accept lengths=...; frame-local ones ignore it
        sig = inspect.signature(self.score)
        kw = {k: v for k, v in kw.items() if k in sig.parameters}
        return self.score(feats, **kw)


_REGISTRY: Dict[str, Callable[..., FeatureScorer]] = {}


def register_scorer(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def create_scorer(name: str, *args, **kwargs) -> FeatureScorer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown feature-scorer-type {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](*args, **kwargs)


class GmmFeatureScorer(FeatureScorer):
    """Diag-GMM scorer over a dense device-resident mixture inventory:
    the fused CUDA kernel on a CUDA device, the plain version on the CPU."""

    def __init__(
        self,
        mixtures: MixtureSet,
        scale: float = 1.0,
        max_approx: bool = True,
        var_floor: float = 1e-4,
        device="cpu",
        tensors: ScoringTensors = None,
    ):
        super().__init__()
        self.tensors = (
            tensors if tensors is not None
            else make_scoring_tensors(mixtures, var_floor, device)
        )
        self.scale = scale
        self.max_approx = max_approx
        self.num_classes = self.tensors.num_mixtures

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.tensors.a.device)
        return self.scale * gmm_scores(feats.contiguous(), self.tensors, self.max_approx)


register_scorer("gmm")(GmmFeatureScorer)
register_scorer("batch-diagonal-maximum")(GmmFeatureScorer)  # reference alias


class PrecomputedScorer(FeatureScorer):
    """Serves an externally computed ``[B, T, M]`` score matrix."""

    def __init__(self, scores: np.ndarray, scale: float = 1.0, device="cpu"):
        super().__init__()
        self._scores = torch.as_tensor(scores, device=device)
        self.scale = scale
        self.num_classes = scores.shape[-1]

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        return self.scale * self._scores


register_scorer("precomputed")(PrecomputedScorer)
