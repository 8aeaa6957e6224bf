"""Fused GMM scoring: host wrapper of ``csrc/gmm_fused.cu`` and its plain twin.

:func:`gmm_scores` maps features ``[..., D]`` to mixture scores
``[..., M]``. On a CUDA tensor it launches the hand-written kernel (or
raises); on a CPU tensor it runs the plain version,
:func:`gmm_scores_plain` (= ``models.gmm.mixture_scores``: two matrix
products materialising ``[N, M*K]``, then the per-mixture reduction).
"""

from __future__ import annotations

import torch

from ... import _build
from ...models.gmm import ScoringTensors
from ...models.gmm import mixture_scores as gmm_scores_plain

__all__ = ["gmm_scores", "gmm_scores_plain"]


def gmm_scores(feats: torch.Tensor, st: ScoringTensors, max_approx: bool = True):
    """[..., D] -> [..., M] emission scores (kernel on CUDA)."""
    if not feats.is_cuda:
        return gmm_scores_plain(feats, st, max_approx)
    lead = feats.shape[:-1]
    x = feats.reshape(-1, feats.shape[-1])
    N, D = x.shape
    M, K = st.num_mixtures, st.max_densities
    if x.dtype != torch.float32:
        raise TypeError(f"features must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("features must be contiguous")
    if D != st.dim:
        raise ValueError(f"feature dim {D} != model dim {st.dim}")
    for name, t, shape in (("a_k", st.a_k, (K, D, M)), ("b_k", st.b_k, (K, D, M)),
                           ("c_k", st.c_k, (K, M))):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, features on {x.device}")
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}")
    out = torch.empty((N, M), dtype=torch.float32, device=x.device)
    if N:
        lib = _build.library()
        code = lib.gmm_scores_launch(
            x.data_ptr(), st.a_k.data_ptr(), st.b_k.data_ptr(), st.c_k.data_ptr(),
            out.data_ptr(), N, D, M, K, int(bool(max_approx)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(code, "gmm_scores")
        gmm_scores.launches += 1
    return out.reshape(*lead, M)


#: launches of the CUDA kernel since the last reset (plain runs not counted)
gmm_scores.launches = 0
