"""The best path of an utterance over the whole search space, with no beam.

Every lexicon word is a chain of its own (its phones as triphones, tied as
:class:`decode.Model` ties them); a word may follow any word or a silence,
and pays the bigram LM's cost times the LM scale on entry; a silence keeps
the history and pays no LM cost. With a bigram LM a path's future depends
on its last word alone, so one copy of each word's chain and one silence
chain per history hold the best of every path: a Viterbi pass over them,
frame by frame in float64, finds the best path exactly. Its cost is the
one :func:`decode.path_score` gives its words and word ends, and no
decoder that searches the same model can score better.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from .decode import SILENCE, Model

INF = math.inf


def _exact(x):
    return x


class WordLoop:
    """The search space of a configuration's lexicon and bigram LM, as
    tensors on ``device``."""

    def __init__(self, model: Model, words: Sequence[Tuple[str, List[str]]], device):
        self.device = device
        f64 = dict(dtype=torch.float64, device=device)
        self.orths = [orth for orth, _ in words]
        cls, loop, fwd_in, skip_in, first, last, exits = [], [], [], [], [], [], []
        for orth in self.orths:
            chain, exit_cost = model.chain(orth)
            first.append(len(cls))
            for k, (c, lp, _, _) in enumerate(chain):
                cls.append(c)
                loop.append(lp)
                fwd_in.append(chain[k - 1][2] if k >= 1 else INF)
                skip_in.append(chain[k - 2][3] if k >= 2 else INF)
            last.append(len(cls) - 1)
            exits.append(exit_cost)
        self.cls = torch.tensor(cls, device=device)
        self.loop, self.fwd_in, self.skip_in = (torch.tensor(v, **f64) for v in (loop, fwd_in, skip_in))
        self.first = torch.tensor(first, device=device)
        self.last = torch.tensor(last, device=device)
        self.exit = torch.tensor(exits, **f64)
        sil, self.sil_exit = model.chain(SILENCE)
        if len(sil) != 1:
            raise ValueError("the word loop takes a one-state silence")
        self.sil_cls, self.sil_loop = sil[0][0], sil[0][1]
        # the LM: each word's vocabulary id, unigram and backoff costs, bigrams
        V = len(model.vocab)
        self.V, self.bos, self.eos = V, model.vocab["<s>"], model.vocab["</s>"]
        self.vid = torch.tensor([model.vocab[o] for o in self.orths], device=device)
        self.word_of = torch.full((V,), -1, dtype=torch.long, device=device)
        self.word_of[self.vid] = torch.arange(len(self.orths), device=device)
        s = model.lm_scale
        uni, bo = [0.0] * V, [0.0] * V
        bh, bw, bc = [], [], []
        for key, (cost, backoff) in model.ngrams.items():
            if len(key) == 1:
                uni[key[0]], bo[key[0]] = cost, backoff
            else:
                bh.append(key[0])
                bw.append(key[1])
                bc.append(cost)
        self.uni = torch.tensor(uni, **f64) * s
        self.bo = torch.tensor(bo, **f64) * s
        self.bh = torch.tensor(bh, dtype=torch.long, device=device)
        self.bw = torch.tensor(bw, dtype=torch.long, device=device)
        self.bc = torch.tensor(bc, **f64) * s
        self.is_bigram = torch.zeros(V, V, dtype=torch.bool, device=device)
        self.is_bigram[self.bh, self.bw] = True
        # a word's backoff entry comes from the best history without a
        # bigram to it: among the k best, k one more than any word's bigrams
        self.k = min(V, int(torch.bincount(self.bw, minlength=V).max()) + 1)
        self.end_cost = self.bo + self.uni[self.eos]
        to_eos = self.bw == self.eos
        self.end_cost[self.bh[to_eos]] = self.bc[to_eos]

    def entry(self, E: torch.Tensor):
        """Each word's best entry cost from the histories' costs ``E``
        [V], and the history it comes from."""
        a = E + self.bo
        vals, idx = torch.topk(a, self.k, largest=False)
        free = ~self.is_bigram[idx][:, self.vid]  # [k, W]
        j = free.to(torch.int32).argmax(0)
        back = vals[j] + self.uni[self.vid]
        back_from = idx[j]
        cand = E[self.bh] + self.bc
        best = torch.full((self.V,), INF, dtype=torch.float64, device=self.device)
        best.scatter_reduce_(0, self.bw, cand, "amin")
        hit = cand == best[self.bw]
        big_from = torch.full((self.V,), -1, dtype=torch.long, device=self.device)
        big_from[self.bw[hit]] = self.bh[hit]
        big = best[self.vid]
        use_back = back <= big
        return torch.where(use_back, back, big), torch.where(use_back, back_from,
                                                             big_from[self.vid])

    def best(self, emis: torch.Tensor, rnd=_exact):
        """The best path over ``emis`` [frames, classes]: its cost, its
        words (orths, silence included) and the frame each ends at.
        ``rnd`` rounds every sum (the lower-precision control)."""
        T = emis.shape[0]
        dev, W, V = self.device, len(self.orths), self.V
        e = emis.to(device=dev, dtype=torch.float64)
        S = len(self.cls)
        cost = torch.full((S,), INF, dtype=torch.float64, device=dev)
        start = torch.zeros(S, dtype=torch.long, device=dev)
        sil = torch.full((V,), INF, dtype=torch.float64, device=dev)
        sil_start = torch.zeros(V, dtype=torch.long, device=dev)
        E = torch.full((V,), INF, dtype=torch.float64, device=dev)
        E[self.bos] = 0.0
        entered_from = torch.empty(T, W, dtype=torch.long, device=dev)
        ended_from = torch.empty(T, V, dtype=torch.long, device=dev)
        ended_in_silence = torch.empty(T, V, dtype=torch.bool, device=dev)
        for t in range(T):
            new, st = rnd(cost + self.loop), start.clone()
            for off, move in ((1, self.fwd_in), (2, self.skip_in)):
                c = rnd(cost[:-off] + move[off:])
                better = c < new[off:]
                new[off:] = torch.where(better, c, new[off:])
                st[off:] = torch.where(better, start[:-off], st[off:])
            ent, entered_from[t] = self.entry(E)
            ent = rnd(ent)
            better = ent < new[self.first]
            new[self.first] = torch.where(better, ent, new[self.first])
            st[self.first] = torch.where(better, t, st[self.first])
            cost, start = rnd(new + e[t, self.cls]), st
            # a silence per history: it loops, or starts where the history ended
            snew = rnd(sil + self.sil_loop)
            better = E < snew
            sil = rnd(torch.where(better, E, snew) + e[t, self.sil_cls])
            sil_start = torch.where(better, t, sil_start)
            E = torch.full((V,), INF, dtype=torch.float64, device=dev)
            E[self.vid] = rnd(cost[self.last] + self.exit)
            origin = torch.zeros(V, dtype=torch.long, device=dev)
            origin[self.vid] = start[self.last]
            x = rnd(sil + self.sil_exit)
            in_sil = x < E
            E = torch.where(in_sil, x, E)
            ended_from[t] = torch.where(in_sil, sil_start, origin)
            ended_in_silence[t] = in_sil
        total = rnd(E + self.end_cost)
        h = int(torch.argmin(total))
        score = float(total[h])
        if not math.isfinite(score):
            return INF, [], []
        froms, silent, entered = (v.cpu() for v in (ended_from, ended_in_silence, entered_from))
        words, ends, t = [], [], T - 1
        while t >= 0:
            begin = int(froms[t, h])
            ends.append(t)
            if silent[t, h]:
                words.append(SILENCE)
            else:
                w = int(self.word_of[h])
                words.append(self.orths[w])
                h = int(entered[begin, w])
            t = begin - 1
        return score, words[::-1], ends[::-1]
