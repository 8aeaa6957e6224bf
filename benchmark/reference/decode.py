"""The score of a decoded word sequence, from the model's definition.

Given the lemmas a decode returned, the frame at which each ends, and the
utterance's emission scores, :func:`path_score` works out the best score
of that segmentation: within each segment a Viterbi pass over the word's
HMM chain (the word's phones as 3-state triphones, word-internal contexts
only, tied to classes by the configuration's hash; loop, forward and
within-phone skip penalties; the exit penalty at the word's end), plus the
LM's bigram costs times the LM scale at each word end and at the
sentence end. It needs no network and no search: the decode's own score
must equal it, up to rounding, whenever the search kept its path's best
alignment.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

SILENCE = "[SILENCE]"
SILENCE_PHONE = "si"
INF = math.inf


class Model:
    """Pronunciations, state classes, penalties and the LM of a
    configuration's draws."""

    def __init__(self, cfg: dict, words: Sequence[Tuple[str, List[str]]], vocab: Dict[str, int],
                 ngrams: Dict[Tuple[int, ...], Tuple[float, float]]):
        h = cfg["hmm"]
        self.states = h["states_per_phone"]
        self.sil_states = h["silence_states"]
        self.speech = {k: (INF if v is None else v) for k, v in h["speech_tdp"].items()}
        self.silence = {k: (INF if v is None else v) for k, v in h["silence_tdp"].items()}
        if h["skip_scope"] != "phone":
            raise NotImplementedError("the decode network's skips stay within a phone")
        self.classes = cfg["tying"]["num_classes"]
        self.mult = cfg["tying"]["multipliers"]
        self.lm_scale = cfg["beam"]["lm_scale"]
        # phone ids: the silence phone first, then the speech phones in order
        self.phone_id = {SILENCE_PHONE: 1}
        for i in range(cfg["lexicon"]["num_phones"]):
            self.phone_id[f"p{i}"] = i + 2
        self.pron = {SILENCE: [SILENCE_PHONE]}
        self.pron.update({orth: list(p) for orth, p in words})
        self.vocab = vocab
        self.ngrams = ngrams

    def tied(self, center: int, left: int, right: int, state: int) -> int:
        a, b, c, d = self.mult
        h = (center * a) ^ (left * b) ^ (right * c) ^ (state * d)
        return 1 + h % (self.classes - 1)

    def chain(self, orth: str):
        """The word's states: (class, loop, forward to the next, skip to
        the one after) per state, and the exit penalty."""
        pron = self.pron[orth]
        ids = [self.phone_id[p] for p in pron]
        out = []
        for i, pid in enumerate(ids):
            sil = pron[i] == SILENCE_PHONE
            tdp = self.silence if sil else self.speech
            if sil:
                left = right = 0
            else:
                left = ids[i - 1] if i > 0 else 0
                right = ids[i + 1] if i < len(ids) - 1 else 0
                left = 0 if left == 1 else left
                right = 0 if right == 1 else right
            n = self.sil_states if sil else self.states
            for s in range(n):
                skip = tdp["skip"] if s + 2 < n else INF
                out.append([self.tied(pid, left, right, s), tdp["loop"], tdp["forward"], skip])
        last = pron[-1] == SILENCE_PHONE
        exit_cost = (self.silence if last else self.speech)["exit"]
        return out, exit_cost

    def lm_cost(self, prev: int, word: int) -> float:
        e = self.ngrams.get((prev, word))
        if e is not None:
            return e[0]
        return self.ngrams[(prev,)][1] + self.ngrams[(word,)][0]


def segment_cost(chain, emis: np.ndarray) -> float:
    """Best cost of passing through ``chain`` over all frames of ``emis``
    (``[frames, classes]``, float64), entering its first state at the
    first frame and leaving its last state at the last."""
    cls = np.array([c[0] for c in chain])
    loop = np.array([c[1] for c in chain])
    fwd = np.array([c[2] for c in chain])
    skip = np.array([c[3] for c in chain])
    S = len(chain)
    cost = np.full(S, INF)
    cost[0] = emis[0, cls[0]]
    for t in range(1, emis.shape[0]):
        new = cost + loop
        new[1:] = np.minimum(new[1:], cost[:-1] + fwd[:-1])
        if S > 2:
            new[2:] = np.minimum(new[2:], cost[:-2] + skip[:-2])
        cost = new + emis[t, cls]
    return float(cost[-1])


def path_score(model: Model, lemmas: Sequence[str], ends: Sequence[int], n_frames: int,
               emis: np.ndarray) -> float:
    """The best score of the decode's segmentation: ``lemmas`` (orths)
    ending at frames ``ends``, over an utterance of ``n_frames`` frames
    with emission scores ``emis`` (``[n_frames, classes]``). Infinite when
    the segmentation is not a path (a segment shorter than its word's
    states allow, frames left over at the end)."""
    if not lemmas or ends[-1] != n_frames - 1 or any(b <= a for a, b in zip(ends, ends[1:])):
        return INF
    total, start = 0.0, 0
    hist = model.vocab["<s>"]
    for orth, end in zip(lemmas, ends):
        if orth not in model.pron:
            return INF
        chain, exit_cost = model.chain(orth)
        # the segment's cost continues the path's running sum
        seg = emis[start:end + 1].copy()
        seg[0] = seg[0] + total
        total = segment_cost(chain, seg) + exit_cost
        if orth != SILENCE:
            wid = model.vocab[orth]
            total = total + model.lm_scale * model.lm_cost(hist, wid)
            hist = wid
        start = end + 1
    return float(total + model.lm_scale * model.lm_cost(hist, model.vocab["</s>"]))
