"""Lattice-free MMI (LF-MMI) and state-level sMBR, in PyTorch.

Counterpart of ``rasr_tpu/train/lfmmi.py``: the denominator is a small
phone-LM graph evaluated exactly every step (no decoding pass, no
lattices). Its forward pass is a loop over frames of log-sum-exp
products with a dense ``[S, S]`` transition matrix, batched over
utterances; the MMI gradient with respect to the emissions (numerator
minus denominator occupancies) comes from autograd through the
recursions, with no hand-written backward.

Cost-domain conventions follow the repo: scores are -log probabilities,
``BIG`` = 1e30 is the pseudo-infinity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve
from ..models.hmm import TransitionModel
from ..ops.viterbi import BIG, forward_total


@dataclasses.dataclass(frozen=True)
class DenseFsa:
    """Dense cost-domain automaton with per-state emissions.

    trans[s0, s1] = -log transition prob (BIG = absent); states EMIT on
    entry (emission class per state), the convention of ``ops.viterbi``.
    """

    trans: torch.Tensor  # [S, S] float32
    emis_class: torch.Tensor  # [S] int64
    init: torch.Tensor  # [S] float32
    final: torch.Tensor  # [S] float32

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    def to(self, device) -> "DenseFsa":
        return DenseFsa(*(t.to(device) for t in (self.trans, self.emis_class, self.init,
                                                 self.final)))


def build_phone_bigram_den(
    num_phones: int,
    states_per_phone: int,
    classify,  # (phone, state) -> emission class id
    bigram_costs: np.ndarray,  # [P, P] -log p(p1 | p0)
    unigram_costs: Optional[np.ndarray] = None,  # [P] start costs
    trans: TransitionModel = TransitionModel(),
    states_of=None,  # optional per-phone state count [P]
    device=None,
) -> DenseFsa:
    """Denominator graph: all phone sequences under a phone-bigram LM.

    States are (phone, hmm_state) chains with the model's loop / forward
    TDPs; leaving a phone's last state applies exit TDP + bigram cost into
    every next phone's first state. ``states_of`` gives per-phone state
    counts (e.g. 1 for context-independent silence), else
    ``states_per_phone`` each. Built on the host, placed on ``device``.
    """
    P = num_phones
    counts = ([int(states_of[p]) for p in range(P)] if states_of is not None
              else [states_per_phone] * P)
    offset = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    S = int(offset[-1])
    tdp = trans.speech
    T = np.full((S, S), BIG, np.float32)
    ecls = np.zeros(S, np.int64)
    for p in range(P):
        Qp = counts[p]
        for q in range(Qp):
            s = int(offset[p]) + q
            ecls[s] = classify(p, q)
            T[s, s] = tdp.loop
            if q + 1 < Qp:
                T[s, s + 1] = tdp.forward
                if q + 2 < Qp and np.isfinite(tdp.skip) and tdp.skip < BIG / 2:
                    T[s, s + 2] = tdp.skip
        # phone end -> next phone starts
        end = int(offset[p]) + Qp - 1
        for p2 in range(P):
            T[end, int(offset[p2])] = np.minimum(
                T[end, int(offset[p2])], tdp.exit + bigram_costs[p, p2])
    init = np.full(S, BIG, np.float32)
    final = np.full(S, BIG, np.float32)
    for p in range(P):
        init[int(offset[p])] = unigram_costs[p] if unigram_costs is not None else 0.0
        final[int(offset[p]) + counts[p] - 1] = tdp.exit
    device = resolve(device)
    return DenseFsa(*(torch.from_numpy(a).to(device) for a in (T, ecls, init, final)))


def _nlse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """-logsumexp(-x) along ``dim``: the sum-semiring reduce in cost
    domain, BIG-safe (the sum is clamped before its log, so a dead row's
    discarded branch stays finite and its gradient zero)."""
    m = torch.amin(x, dim=dim)
    dead = m >= BIG / 2
    safe = torch.where(dead, torch.zeros_like(m), m)
    s = torch.exp(-(x - safe.unsqueeze(dim))).sum(dim=dim)
    out = safe - torch.log(s.clamp(min=1e-37))
    return torch.where(dead, torch.full_like(out, BIG), out)


def _forward_sts(e: torch.Tensor, fsa: DenseFsa, n_frames: torch.Tensor) -> torch.Tensor:
    """Forward total ``[B]`` over pre-expanded per-STATE -log scores
    ``[B, T, S]`` (BIG where n_frames is 0)."""
    B, T, S = e.shape
    n_frames = n_frames.to(torch.int64)
    active = (torch.arange(T, device=e.device)[:, None] < n_frames[None, :])[..., None]
    alpha = (fsa.init[None] + e[:, 0]).clamp(max=BIG)
    for t in range(1, T):
        new = _nlse(alpha[:, :, None] + fsa.trans[None], dim=1) + e[:, t]
        alpha = torch.where(active[t], new.clamp(max=BIG), alpha)
    # alpha is frozen from frame n_frames on: each utterance's last frame
    total = _nlse(alpha + fsa.final[None], dim=1)
    return torch.where(n_frames >= 1, total, torch.full_like(total, BIG))


def _per_state(emissions: torch.Tensor, fsa: DenseFsa) -> torch.Tensor:
    return emissions.clamp(max=BIG).index_select(2, fsa.emis_class)


def dense_forward(emissions: torch.Tensor, fsa: DenseFsa, n_frames) -> torch.Tensor:
    """Total -log sum over all paths ``[B]`` of emissions ``[B, T, M]``;
    differentiable: the gradient with respect to the emissions is the
    state-occupancy posterior summed into emission classes."""
    return _forward_sts(_per_state(emissions, fsa), fsa, torch.as_tensor(n_frames))


def expected_accuracy(
    emissions: torch.Tensor,  # [B, T, M] -log acoustic scores
    fsa: DenseFsa,
    n_frames,  # [B]
    ref_labels: torch.Tensor,  # [B, T] reference class ids (-1 = no reference)
    class_map: Optional[torch.Tensor] = None,  # [M] coarser unit per class
) -> torch.Tensor:
    """E over the denominator posterior of the number of frames whose state
    class (or ``class_map`` unit) matches the reference: the state-level
    sMBR objective ``[B]``, to be maximized.

    With Z(k) = sum over paths of exp(-cost + k acc), E[acc] = d log Z / dk
    at k = 0 = sum over (t, s) of acc x d(total) / d(e): the reference
    takes this directional derivative with ``jax.jvp``; here it is the
    first-order form, the per-state gradient of the forward total taken
    with ``create_graph`` so that training differentiates it again."""
    B, T, _ = emissions.shape
    n_frames = torch.as_tensor(n_frames, device=emissions.device).to(torch.int64)
    ref_labels = torch.as_tensor(ref_labels, device=emissions.device).to(torch.int64)
    state_unit, ref_unit = fsa.emis_class, ref_labels
    if class_map is not None:
        state_unit = class_map[fsa.emis_class]
        # keep the -1 (unscored) sentinel out of the map
        ref_unit = torch.where(ref_labels >= 0, class_map[ref_labels.clamp(min=0)], -1)
    acc = (state_unit[None, None, :] == ref_unit[:, :, None]).to(torch.float32)
    valid = (ref_labels >= 0) & (torch.arange(T, device=emissions.device)[None, :]
                                 < n_frames[:, None])
    acc = acc * valid.to(torch.float32)[:, :, None]
    with torch.enable_grad():
        e = _per_state(emissions, fsa)
        if not e.requires_grad:
            e = e.detach().requires_grad_(True)
        total = _forward_sts(e, fsa, n_frames)
        (occ,) = torch.autograd.grad(total.sum(), e, create_graph=emissions.requires_grad)
    return (occ * acc).sum(dim=(1, 2))


def lfmmi_loss(emissions: torch.Tensor, num_total: torch.Tensor, den_fsa: DenseFsa,
               n_frames) -> torch.Tensor:
    """Per-utterance MMI cost = num_cost - den_cost (minimize). num_total
    must come from the SAME emissions tensor so that gradients flow
    through both terms."""
    return num_total - dense_forward(emissions, den_fsa, n_frames)


def lfmmi_grad_emissions(emissions, den_fsa: DenseFsa, n_frames, num_loop, num_fwd, num_skip,
                         num_init, num_final, num_classes):
    """(summed loss, d loss / d emissions ``[B, T, M]``) for a batch whose
    numerators are banded linear alignment graphs (``num_classes``
    ``[B, Sg]``: the emission class per graph state). The gradient is the
    numerator minus the denominator occupancy per emission class, by
    autograd."""
    emis = torch.as_tensor(emissions).detach().requires_grad_(True)
    n_frames = torch.as_tensor(n_frames, device=emis.device)
    with torch.enable_grad():
        B, T, _ = emis.shape
        idx = torch.as_tensor(num_classes, device=emis.device).to(torch.int64)
        num_emis = emis.gather(2, idx[:, None, :].expand(B, T, idx.shape[1]))
        num_total = forward_total(num_emis, num_loop, num_fwd, num_skip, num_init, num_final,
                                  n_frames)
        loss = lfmmi_loss(emis, num_total, den_fsa, n_frames).sum()
        (grad,) = torch.autograd.grad(loss, emis)
    return loss.detach(), grad
