"""FSA grammar language model.

Re-implements the reference's automaton-backed LM (ref: src/Lm/ —
Lm::FsaLm [MODULE_LM_FSA]): the word sequence constraint/score comes
from a weighted acceptor over LM tokens; the history is the automaton
state (epsilon-closed), making command-and-control style grammars and
forced-sequence decoding first-class.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from ...fsa.automaton import EPS, Automaton
from .interface import History, LanguageModel


class FsaGrammarLm(LanguageModel):
    """History = frozenset of (state, cost-offset) pairs (eps-closed)."""

    def __init__(self, fsa: Automaton, vocab: Dict[str, int]):
        self.fsa = fsa
        self.vocab = dict(vocab)

    def _closure(self, frontier: Dict[int, float]) -> Dict[int, float]:
        return self.fsa._eps_closure(frontier)

    def start_history(self) -> History:
        h = self._closure({self.fsa.initial: 0.0})
        base = min(h.values(), default=0.0)
        return tuple(sorted((s, round(c - base, 9)) for s, c in h.items()))

    def _advance(self, history: History, word: int) -> Dict[int, float]:
        nxt: Dict[int, float] = {}
        for s, c in history:
            for a in self.fsa.arcs[s]:
                if a.ilabel == word:
                    w = c + a.weight
                    if a.target not in nxt or w < nxt[a.target]:
                        nxt[a.target] = w
        return self._closure(nxt)

    def extended_history(self, history: History, word: int) -> History:
        nxt = self._advance(history, word)
        if not nxt:
            return ()
        base = min(nxt.values())
        return tuple(sorted((s, round(c - base, 9)) for s, c in nxt.items()))

    def score(self, history: History, word: int) -> float:
        nxt = self._advance(history, word)
        if not nxt:
            return 1e9  # word not allowed by the grammar
        return min(nxt.values())

    def sentence_end_score(self, history: History) -> float:
        best = math.inf
        for s, c in history:
            if s in self.fsa.finals:
                best = min(best, c + self.fsa.finals[s])
        return best if best < math.inf else 1e9

    # -------------------------------------------------------------- builders
    @classmethod
    def from_sequences(
        cls, sequences: List[List[str]], costs: List[float] = None
    ) -> "FsaGrammarLm":
        """Grammar accepting exactly the given word sequences."""
        vocab: Dict[str, int] = {}

        def wid(t):
            if t not in vocab:
                vocab[t] = len(vocab) + 1  # 0 = eps
            return vocab[t]

        fsa = Automaton()
        start = fsa.add_state()
        fsa.initial = start
        for i, seq in enumerate(sequences):
            cur = start
            cost = (costs or [0.0] * len(sequences))[i]
            for j, tok in enumerate(seq):
                nxt = fsa.add_state()
                fsa.add_arc(cur, nxt, wid(tok), weight=cost if j == 0 else 0.0)
                cur = nxt
            fsa.set_final(cur)
        return cls(fsa, vocab)
