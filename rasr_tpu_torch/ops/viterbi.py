"""Batched banded Viterbi / forward-backward over linear HMM graphs, in PyTorch.

Counterpart of ``rasr_tpu/ops/viterbi.py``. An alignment graph is a
linear chain whose only transitions are loop / forward / skip, so the DP
is a loop over time of dense ``[B, S]`` tensor ops (the reference's
``lax.scan`` becomes a Python loop: a handful of launches per frame).

Conventions: all scores are -log ("costs", min-sum); :data:`BIG` is the
finite pseudo-infinity (1e30), so float32 arithmetic never makes NaN
from inf - inf.

Inputs per batch element b:
  emissions  [B, T, S]  cost of state s emitting frame t
  loop,fwd,skip [B, S]  cost of entering state s from s / s-1 / s-2
  init       [B, S]     cost of starting in s (BIG if not a start state)
  final      [B, S]     cost of ending in s (exit penalty; BIG if not final)
  n_frames   [B]        valid frame counts (padded frames ignored)

Tied Viterbi candidates break as the reference's ``jnp.argmin`` does, to
the first of ``[loop, fwd, skip]``. :func:`forward_backward` is
differentiable through its total: the LF-MMI numerator takes its
gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

BIG = 1.0e30


def _shift1(x: torch.Tensor) -> torch.Tensor:
    """x[..., s-1] with BIG at s=0."""
    return torch.cat([torch.full_like(x[..., :1], BIG), x[..., :-1]], dim=-1)


def _shift2(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.full_like(x[..., :2], BIG), x[..., :-2]], dim=-1)


def _unshift1(x: torch.Tensor) -> torch.Tensor:
    """x[..., s+1] with BIG at s=S-1."""
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], BIG)], dim=-1)


def _unshift2(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[..., 2:], torch.full_like(x[..., :2], BIG)], dim=-1)


def _nlse(*costs: torch.Tensor) -> torch.Tensor:
    """-log sum exp(-c_i): the sum-semiring combine in cost domain. Where
    every cost is BIG the result is BIG; the sum is clamped before its
    log, so the discarded branch stays finite and its gradient zero."""
    stacked = torch.stack(costs, dim=0)
    m = torch.amin(stacked, dim=0)
    dead = m >= BIG
    safe = torch.where(dead, torch.zeros_like(m), m)  # avoid BIG-BIG
    s = torch.exp(-(stacked - safe)).sum(dim=0)
    out = safe - torch.log(s.clamp(min=1e-37))
    return torch.where(dead, torch.full_like(out, BIG), out)


def _frame_mask(n_frames: torch.Tensor, T: int) -> torch.Tensor:
    """[T, B, 1] bool: frame t is valid for utterance b."""
    t = torch.arange(T, device=n_frames.device)
    return (t[:, None] < n_frames[None, :])[..., None]


@torch.no_grad()
def viterbi_forward(emissions, loop, fwd, skip, init, final, n_frames,
                    return_backpointers: bool = True):
    """Min-sum forward pass.

    Returns (best_cost [B], final_state [B], backpointers [T, B, S] int8;
    row 0 is zero). With ``return_backpointers=False`` no backpointer is
    stored: the third value is all zeros of that shape, a broadcast view
    of one element (the reference returns zero rows there too)."""
    B, T, S = emissions.shape
    emissions = emissions.clamp(max=BIG)
    n_frames = n_frames.to(torch.int64)
    trans = torch.stack([x.expand(B, S) for x in (loop, fwd, skip)])  # [3, B, S]
    # dp behind two BIG columns: the fwd and skip predecessors are views
    dpp = torch.full((B, S + 2), BIG, dtype=emissions.dtype, device=emissions.device)
    dp = dpp[:, 2:]
    dp.copy_((init + emissions[:, 0]).clamp(max=BIG))
    if return_backpointers:
        bps = torch.zeros((T, B, S), dtype=torch.int8, device=emissions.device)
    else:
        bps = torch.zeros((1, 1, 1), dtype=torch.int8, device=emissions.device).expand(T, B, S)
    active = _frame_mask(n_frames, T)
    for t in range(1, T):
        cand = torch.stack([dp, dpp[:, 1:-1], dpp[:, :-2]]) + trans
        if return_backpointers:
            best, bp = cand.min(dim=0)  # the first minimum, as jnp.argmin
            bps[t] = bp
        else:
            best = cand.amin(dim=0)
        dp.copy_(torch.where(active[t], (best + emissions[:, t]).clamp(max=BIG), dp))
    # dp is frozen from frame n_frames on, so it holds each utterance's last frame
    tot = (dp + final).clamp(max=BIG)
    fbest, fstate = tot.min(dim=-1)
    none = n_frames < 1
    fbest = torch.where(none, torch.full_like(fbest, BIG), fbest)
    fstate = torch.where(none, torch.zeros_like(fstate), fstate)
    return fbest, fstate, bps


@torch.no_grad()
def viterbi_backtrace(backpointers, final_state, n_frames) -> torch.Tensor:
    """Recover the state sequence [B, T] (int64); padding frames are -1."""
    T, B, S = backpointers.shape
    n_frames = n_frames.to(torch.int64)
    cur = final_state.to(torch.int64)
    states = torch.empty((T, B), dtype=torch.int64, device=backpointers.device)
    active = _frame_mask(n_frames, T)[..., 0]
    for t in range(T - 1, -1, -1):
        states[t] = torch.where(active[t], cur, -1)
        if t > 0:
            offs = backpointers[t].gather(1, cur[:, None])[:, 0]
            cur = torch.where(active[t], cur - offs, cur)
    return states.T


def viterbi_align(emissions, loop, fwd, skip, init, final, n_frames
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forced alignment: (best_cost [B], state sequence [B, T])."""
    best, fstate, bps = viterbi_forward(emissions, loop, fwd, skip, init, final, n_frames)
    return best, viterbi_backtrace(bps, fstate, n_frames)


def _alphas(emissions, loop, fwd, skip, init, n_frames) -> list:
    """Forward costs, one [B, S] per frame, each including its frame's
    emission; frozen from frame n_frames on."""
    B, T, S = emissions.shape
    active = _frame_mask(n_frames.to(torch.int64), T)
    alpha = (init + emissions[:, 0]).clamp(max=BIG)
    alphas = [alpha]
    for t in range(1, T):
        new = _nlse(alpha + loop, _shift1(alpha) + fwd, _shift2(alpha) + skip) + emissions[:, t]
        alpha = torch.where(active[t], new.clamp(max=BIG), alpha)
        alphas.append(alpha)
    return alphas


def forward_total(emissions, loop, fwd, skip, init, final, n_frames) -> torch.Tensor:
    """-log p(X) [B] from the forward pass alone (0 where n_frames is 0):
    :func:`forward_backward`'s total without the backward pass, for
    objectives that need only the total and its gradient."""
    emissions = emissions.clamp(max=BIG)
    n_frames = n_frames.to(torch.int64)
    alpha = _alphas(emissions, loop, fwd, skip, init, n_frames)[-1]  # frozen at each last frame
    total = -torch.logsumexp(-(alpha + final).clamp(max=BIG), dim=-1)
    return torch.where(n_frames > 0, total, torch.zeros_like(total))


def forward_backward(emissions, loop, fwd, skip, init, final, n_frames
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum-semiring DP -> state occupancy posteriors.

    Returns (total cost [B] = -log p(X), gamma [B, T, S], zero on
    padding)."""
    B, T, S = emissions.shape
    emissions = emissions.clamp(max=BIG)
    n_frames = n_frames.to(torch.int64)
    alphas = torch.stack(_alphas(emissions, loop, fwd, skip, init, n_frames))

    # beta[t, s] = cost from state s at t to the end, EXCLUDING emis[t, s]
    fwd_next, skip_next = _unshift1(fwd), _unshift2(skip)
    final = final.clamp(max=BIG)
    beta = torch.full((B, S), BIG, dtype=emissions.dtype, device=emissions.device)
    betas = [None] * T
    last = (n_frames - 1)[:, None]
    for t in range(T - 1, -1, -1):
        e_next = emissions[:, t + 1] if t + 1 < T else torch.full_like(beta, BIG)
        be = beta + e_next
        prop = _nlse(beta + loop + e_next, _unshift1(be) + fwd_next, _unshift2(be) + skip_next)
        prop = prop.clamp(max=BIG)
        beta = torch.where(last == t, final, torch.where(t < last, prop, beta))
        betas[t] = beta
    betas = torch.stack(betas)

    total = -torch.logsumexp(-(alphas[0] + betas[0]).clamp(max=BIG), dim=-1)
    total = torch.where(n_frames > 0, total, torch.zeros_like(total))
    post = alphas + betas  # [T, B, S] cost of paths through (t, s)
    gamma = torch.exp(-(post - total[None, :, None]))
    keep = _frame_mask(n_frames, T) & (post < BIG / 2)
    gamma = torch.where(keep, gamma, torch.zeros_like(gamma))
    return total, gamma.transpose(0, 1)
