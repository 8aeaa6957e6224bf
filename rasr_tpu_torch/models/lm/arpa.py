"""Backing-off n-gram LM with ARPA I/O.

Re-implements the reference's ARPA/backing-off LM
(ref: src/Lm/ArpaLm.* / BackingOff.* — text ARPA read, internal trie,
history-based scoring). ARPA log10 probabilities are converted to -log
(nats) costs internally.

Backoff semantics (standard ARPA):
    P(w | h) = P_explicit(w | h)                       if (h, w) listed
             = backoff(h) * P(w | h')                  otherwise
with h' = h minus its oldest word; histories not listed have backoff 1.

The host structure is a dict {ngram tuple -> (cost, backoff_cost)} which
is also the input to the device-table compiler (ngram_tpu.py). Parsing
large ARPA files goes through the C++ fast path when built
(native/ — see arpa_native), with this pure-python reader as fallback
and source of truth.
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Optional, Tuple

from .interface import History, LanguageModel

LN10 = math.log(10.0)


class NgramLm(LanguageModel):
    def __init__(
        self,
        order: int,
        vocab: Dict[str, int],
        ngrams: Dict[Tuple[int, ...], Tuple[float, float]],
    ):
        """ngrams: tuple of word ids -> (-log prob, -log backoff)."""
        self.order = order
        self.vocab = dict(vocab)
        self.ngrams = ngrams
        self.inv_vocab = {i: w for w, i in self.vocab.items()}
        self._bos = self.vocab.get("<s>")
        self._unk = self.vocab.get("<unk>")

    # -------------------------------------------------------------- LM api
    def start_history(self) -> History:
        return (self._bos,) if self._bos is not None else ()

    def extended_history(self, history: History, word: int) -> History:
        h = (history + (word,))[-(self.order - 1):] if self.order > 1 else ()
        # truncate to the longest context that actually exists (interning
        # equivalent: shorter contexts score identically)
        while h and h not in self.ngrams:
            h = h[1:]
        return h

    def score(self, history: History, word: int) -> float:
        if word not in self.inv_vocab:
            if self._unk is None:
                return 99.0
            word = self._unk
        h = tuple(history)[-(self.order - 1):] if self.order > 1 else ()
        backoff = 0.0
        while True:
            entry = self.ngrams.get(h + (word,))
            if entry is not None:
                return backoff + entry[0]
            if not h:
                # even the unigram is missing (word outside LM): fall back
                # to <unk> or a large cost
                if self._unk is not None and word != self._unk:
                    word = self._unk
                    continue
                return backoff + 99.0
            ctx = self.ngrams.get(h)
            if ctx is not None:
                backoff += ctx[1]
            h = h[1:]

    # ----------------------------------------------------------------- io
    @classmethod
    def read_arpa(cls, path: str) -> "NgramLm":
        opener = gzip.open if path.endswith(".gz") else open
        vocab: Dict[str, int] = {}
        ngrams: Dict[Tuple[int, ...], Tuple[float, float]] = {}
        order = 0

        def wid(token: str) -> int:
            if token not in vocab:
                vocab[token] = len(vocab)
            return vocab[token]

        with opener(path, "rt", encoding="utf-8") as fh:
            section = 0  # 0=preamble, n=reading n-grams
            for raw in fh:
                line = raw.strip()
                if not line:
                    continue
                if line.startswith("\\data\\"):
                    section = 0
                    continue
                if line.startswith("\\end\\"):
                    break
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    order = max(order, section)
                    continue
                if section == 0:
                    continue  # ngram N=count lines
                parts = line.split("\t") if "\t" in line else line.split()
                logp = float(parts[0])
                if "\t" in line:
                    tokens = parts[1].split()
                    backoff = float(parts[2]) if len(parts) > 2 else 0.0
                else:
                    # whitespace-separated: logp w1..wn [backoff]
                    if len(parts) == section + 2:
                        tokens, backoff = parts[1:-1], float(parts[-1])
                    else:
                        tokens, backoff = parts[1:], 0.0
                gram = tuple(wid(t) for t in tokens)
                ngrams[gram] = (-logp * LN10, -backoff * LN10)
        if order == 0:
            raise ValueError(f"{path}: no n-gram sections found")
        return cls(order, vocab, ngrams)

    def write_arpa(self, path: str) -> None:
        by_order: Dict[int, List[Tuple[Tuple[int, ...], Tuple[float, float]]]] = {}
        for gram, entry in self.ngrams.items():
            by_order.setdefault(len(gram), []).append((gram, entry))
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("\\data\\\n")
            for n in range(1, self.order + 1):
                fh.write(f"ngram {n}={len(by_order.get(n, []))}\n")
            for n in range(1, self.order + 1):
                fh.write(f"\n\\{n}-grams:\n")
                for gram, (cost, bo) in by_order.get(n, []):
                    words = " ".join(self.inv_vocab[w] for w in gram)
                    logp = -cost / LN10
                    if bo != 0.0:
                        fh.write(f"{logp:.6f}\t{words}\t{-bo / LN10:.6f}\n")
                    else:
                        fh.write(f"{logp:.6f}\t{words}\n")
            fh.write("\n\\end\\\n")

    # ------------------------------------------------------------- counting
    @classmethod
    def train_from_text(
        cls,
        sentences: List[List[str]],
        order: int = 3,
        discount: float = 0.4,
    ) -> "NgramLm":
        """Tiny absolute-discounting trainer for tests/toys (the reference
        ships no LM trainer either — LMs come from external tools; this
        exists so the framework is self-contained for experiments)."""
        vocab = {"<s>": 0, "</s>": 1}
        counts: Dict[Tuple[int, ...], float] = {}
        ctx_totals: Dict[Tuple[int, ...], float] = {}

        def wid(t):
            if t not in vocab:
                vocab[t] = len(vocab)
            return vocab[t]

        for sent in sentences:
            ids = [vocab["<s>"]] + [wid(t) for t in sent] + [vocab["</s>"]]
            for n in range(1, order + 1):
                for i in range(len(ids) - n + 1):
                    gram = tuple(ids[i : i + n])
                    if n == 1 and gram == (vocab["<s>"],):
                        continue  # never predict <s>
                    counts[gram] = counts.get(gram, 0.0) + 1.0
                    ctx_totals[gram[:-1]] = ctx_totals.get(gram[:-1], 0.0) + 1.0

        ngrams: Dict[Tuple[int, ...], Tuple[float, float]] = {}
        V = len(vocab) - 1  # exclude <s> as predicted event
        for gram, c in counts.items():
            ctx = gram[:-1]
            total = ctx_totals[ctx]
            p = max(c - discount, 1e-10) / total
            ngrams[gram] = (-math.log(p), 0.0)
        # backoff mass per context (grouped once: the per-context scans
        # were O(|counts|^2) and made 4-gram training at battery scale
        # take hours instead of seconds)
        by_ctx: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}
        for g in counts:
            by_ctx.setdefault(g[:-1], []).append(g)
        for ctx, total in ctx_totals.items():
            members = by_ctx.get(ctx, [])
            n_types = len(members)
            mass = discount * n_types / total
            lower_sum = 0.0
            for g in members:
                lower = g[1:]
                if lower in ngrams:
                    lower_sum += math.exp(-ngrams[lower][0])
            denom = max(1.0 - lower_sum, 1e-10)
            bo = mass / denom
            if ctx:
                if ctx in ngrams:
                    cost, _ = ngrams[ctx]
                    ngrams[ctx] = (cost, -math.log(max(bo, 1e-10)))
                else:
                    ngrams[ctx] = (99.0 * 1.0, -math.log(max(bo, 1e-10)))
        # ensure <s> context exists for start history
        bos = (vocab["<s>"],)
        if bos not in ngrams:
            ngrams[bos] = (99.0, 0.0)
        return cls(order, vocab, ngrams)
