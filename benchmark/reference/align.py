"""Forced alignment and the GMM statistics of aligned frames, in float64.

The alignment topology is the configuration's: the transcript's words in
order, each a chain of its phones' states (word-internal triphones), with
an optional one-state silence before, between and after the words. A
state loops (its phone's loop penalty) or moves on to the next (the
phone's forward penalty; a word's last state pays the exit penalty
instead); a speech state may skip the next within its word, and a word
may skip the silence after it; the path starts in the first state (or in
the first word's, past the leading silence) and ends in the last (or the
last word's, before the trailing silence), paying its exit penalty.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from .decode import SILENCE, Model

INF = math.inf


def chain(model: Model, words: Sequence[str]):
    """The utterance's states: (class, loop, enter-from-previous,
    enter-from-two-back, is silence) per state, and start and end costs."""
    states: List[list] = []  # class, loop, leave, skip-out, silence, word index
    sil_chain, _ = model.chain(SILENCE)

    def silence():
        c = sil_chain[0]
        states.append([c[0], c[1], model.silence["exit"], INF, True, -1])

    silence()
    for w, orth in enumerate(words):
        word, exit_cost = model.chain(orth)
        for k, c in enumerate(word):
            last = k == len(word) - 1
            states.append([c[0], c[1], exit_cost if last else c[2], model.speech["skip"],
                           False, w])
        silence()
    S = len(states)
    cls = np.array([s[0] for s in states])
    loop = np.array([s[1] for s in states], np.float64)
    fwd = np.full(S, INF)
    skip = np.full(S, INF)
    for j in range(1, S):
        fwd[j] = states[j - 1][2]
        if j >= 2:
            a, b, c = states[j - 2], states[j - 1], states[j]
            if b[4] and not a[4] and not c[4]:
                skip[j] = a[2]  # past the optional silence
            elif a[5] == c[5] and not a[4]:
                skip[j] = a[3]  # within the word
    init = np.full(S, INF)
    init[0] = init[1] = 0.0
    final = np.full(S, INF)
    final[S - 1] = states[S - 1][2]
    final[S - 2] = states[S - 2][2]
    return cls, loop, fwd, skip, init, final


def best(cls, loop, fwd, skip, init, final, emis: np.ndarray):
    """The best alignment's cost, and its state per frame."""
    T, S = emis.shape[0], len(cls)
    e = emis[:, cls]
    cost = init + e[0]
    back = np.zeros((T, S), np.int8)
    for t in range(1, T):
        cand = np.stack([cost + loop,
                         np.concatenate([[INF], cost[:-1]]) + fwd,
                         np.concatenate([[INF, INF], cost[:-2]]) + skip])
        back[t] = np.argmin(cand, axis=0)
        cost = cand[back[t], np.arange(S)] + e[t]
    total = cost + final
    s = int(np.argmin(total))
    path = [s]
    for t in range(T - 1, 0, -1):
        s -= int(back[t, s])
        path.append(s)
    return float(total.min()), np.array(path[::-1])


def path_cost(cls, loop, fwd, skip, init, final, emis: np.ndarray, path) -> float:
    """The cost of one state sequence (infinite when it is not a path)."""
    path = np.asarray(path)
    total = init[path[0]] + emis[0, cls[path[0]]]
    for t in range(1, len(path)):
        step = path[t] - path[t - 1]
        move = {0: loop, 1: fwd, 2: skip}.get(int(step))
        if move is None:
            return INF
        total += move[path[t]] + emis[t, cls[path[t]]]
    return float(total + final[path[-1]])


def statistics(feats: torch.Tensor, labels: torch.Tensor, gmm: dict, var_floor: float):
    """Each density's posterior-weighted count, sum and sum of squares
    over frames labelled with its class (``labels`` -1 = no frame)."""
    dev = feats.device
    mean = torch.as_tensor(gmm["means"], device=dev, dtype=torch.float64)
    var = torch.clamp(torch.as_tensor(gmm["variances"], device=dev, dtype=torch.float64),
                      min=var_floor)
    logw = torch.log(torch.as_tensor(gmm["weights"], device=dev, dtype=torch.float64))
    M, K, D = mean.shape
    keep = labels >= 0
    x, lab = feats[keep].double(), labels[keep].long()
    ll = logw[lab] - 0.5 * (torch.log(var[lab]) + (x[:, None] - mean[lab]) ** 2 / var[lab]).sum(-1)
    g = torch.softmax(ll, dim=-1)  # [N, K]
    count = torch.zeros(M, K, dtype=torch.float64, device=dev).index_add_(0, lab, g)
    s1 = torch.zeros(M, K, D, dtype=torch.float64, device=dev).index_add_(
        0, lab, g[..., None] * x[:, None])
    s2 = torch.zeros(M, K, D, dtype=torch.float64, device=dev).index_add_(
        0, lab, g[..., None] * (x * x)[:, None])
    return count, s1, s2
