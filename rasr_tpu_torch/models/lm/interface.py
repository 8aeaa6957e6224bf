"""Language model interfaces (host side).

Mirrors the reference's history-based LM API (ref: src/Lm/LanguageModel.*
— startHistory / extendedHistory / score with interned opaque histories).
Host-side LMs serve lattice rescoring, perplexity tools and tests; the
decoder consumes the *compiled* device tables (ngram_tpu.py) whose state
ids play the role of the reference's interned histories.

Scores are -log probabilities in natural log (nats). Special tokens
follow ARPA conventions: <s>, </s>, <unk>.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

History = Tuple[int, ...]  # word ids, most recent last


class LanguageModel:
    """History-based scoring API (ref: Lm::LanguageModel)."""

    vocab: Dict[str, int]

    def start_history(self) -> History:  # pragma: no cover - interface
        raise NotImplementedError

    def extended_history(self, history: History, word: int) -> History:
        raise NotImplementedError

    def score(self, history: History, word: int) -> float:
        """-log P(word | history)."""
        raise NotImplementedError

    def sentence_end_score(self, history: History) -> float:
        return self.score(history, self.vocab["</s>"]) if "</s>" in self.vocab else 0.0

    # ----------------------------------------------------------- conveniences
    def word_id(self, token: str) -> int:
        if token in self.vocab:
            return self.vocab[token]
        if "<unk>" in self.vocab:
            return self.vocab["<unk>"]
        raise KeyError(f"OOV token {token!r} and no <unk>")

    def sequence_score(self, tokens: Sequence[str]) -> float:
        """-log P of a sentence (with <s> context and </s> scored)."""
        h = self.start_history()
        total = 0.0
        for tok in tokens:
            w = self.word_id(tok)
            total += self.score(h, w)
            h = self.extended_history(h, w)
        total += self.sentence_end_score(h)
        return total

    def perplexity(self, tokens: Sequence[str]) -> float:
        n = len(tokens) + 1  # + sentence end
        return math.exp(self.sequence_score(tokens) / max(n, 1))


class Zerogram(LanguageModel):
    """Uniform LM over the vocabulary (ref: Lm::Zerogram)."""

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = dict(vocab)
        n = max(len([w for w in vocab if w not in ("<s>",)]), 1)
        self._score = math.log(n)

    def start_history(self) -> History:
        return ()

    def extended_history(self, history: History, word: int) -> History:
        return ()

    def score(self, history: History, word: int) -> float:
        return self._score


class ScaledLanguageModel(LanguageModel):
    """Wrapper applying a global scale (ref: Lm::ScaledLanguageModel)."""

    def __init__(self, inner: LanguageModel, scale: float):
        self.inner = inner
        self.scale = scale
        self.vocab = inner.vocab

    def start_history(self) -> History:
        return self.inner.start_history()

    def extended_history(self, history: History, word: int) -> History:
        return self.inner.extended_history(history, word)

    def score(self, history: History, word: int) -> float:
        return self.scale * self.inner.score(history, word)


class CombineLanguageModel(LanguageModel):
    """Log-linear combination (ref: Lm::CombineLm)."""

    def __init__(self, lms: Sequence[LanguageModel], scales: Sequence[float]):
        assert lms and len(lms) == len(scales)
        self.lms = list(lms)
        self.scales = list(scales)
        self.vocab = lms[0].vocab

    def start_history(self) -> History:
        return tuple(lm.start_history() for lm in self.lms)  # type: ignore

    def extended_history(self, history, word: int):
        return tuple(
            lm.extended_history(h, word) for lm, h in zip(self.lms, history)
        )

    def score(self, history, word: int) -> float:
        return sum(
            s * lm.score(h, word)
            for lm, s, h in zip(self.lms, self.scales, history)
        )


class ClassLanguageModel(LanguageModel):
    """Word->class mapped LM with in-class emission scores
    (ref: Lm::ClassLm)."""

    def __init__(self, inner: LanguageModel, word_to_class: Dict[int, int],
                 class_emission: Dict[int, float], vocab: Dict[str, int]):
        self.inner = inner
        self.word_to_class = word_to_class
        self.class_emission = class_emission
        self.vocab = vocab

    def _cls(self, word: int) -> int:
        return self.word_to_class.get(word, word)

    def start_history(self) -> History:
        return self.inner.start_history()

    def extended_history(self, history: History, word: int) -> History:
        return self.inner.extended_history(history, self._cls(word))

    def score(self, history: History, word: int) -> float:
        return self.inner.score(history, self._cls(word)) + self.class_emission.get(word, 0.0)
