"""Pronunciation lexicon.

Parses the reference's Bliss lexicon XML (ref: src/Bliss/Lexicon.*,
src/Bliss/Phoneme.*):

.. code-block:: xml

    <lexicon>
      <phoneme-inventory>
        <phoneme><symbol>ah</symbol></phoneme>
        <phoneme><symbol>si</symbol><variation>none</variation></phoneme>
      </phoneme-inventory>
      <lemma special="silence">
        <orth>[SILENCE]</orth><phon>si</phon>
        <synt/><eval/>
      </lemma>
      <lemma>
        <orth>HELLO</orth><orth>HULLO</orth>
        <phon score="0.0">hh ah l ow</phon>
      </lemma>
    </lexicon>

Special lemmata (silence, sentence-begin, sentence-end, unknown) follow the
reference's conventions. ``variation == "none"`` marks a phoneme
context-independent (used by the allophone builder for e.g. silence).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from ..utils.xmlio import parse_xml
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Phoneme:
    symbol: str
    id: int  # 1-based like the reference (0 reserved / padding)
    context_independent: bool = False


class PhonemeInventory:
    def __init__(self) -> None:
        self._by_symbol: Dict[str, Phoneme] = {}
        self._list: List[Phoneme] = []

    def add(self, symbol: str, context_independent: bool = False) -> Phoneme:
        if symbol in self._by_symbol:
            return self._by_symbol[symbol]
        ph = Phoneme(symbol, len(self._list) + 1, context_independent)
        self._by_symbol[symbol] = ph
        self._list.append(ph)
        return ph

    def __getitem__(self, symbol: str) -> Phoneme:
        return self._by_symbol[symbol]

    def __contains__(self, symbol: str) -> bool:
        return symbol in self._by_symbol

    def __len__(self) -> int:
        return len(self._list)

    def __iter__(self) -> Iterator[Phoneme]:
        return iter(self._list)

    def by_id(self, pid: int) -> Phoneme:
        return self._list[pid - 1]


@dataclass(frozen=True)
class Pronunciation:
    phonemes: Tuple[int, ...]  # phoneme ids
    score: float = 0.0  # -log pronunciation weight

    def __len__(self) -> int:
        return len(self.phonemes)


@dataclass
class Lemma:
    id: int
    orth: List[str]  # orthographic variants; [0] is primary
    pronunciations: List[Pronunciation]
    special: Optional[str] = None  # silence | sentence-begin | sentence-end | unknown
    synt: Optional[List[str]] = None  # syntactic token sequence (LM tokens)
    evals: Optional[List[List[str]]] = None  # evaluation token sequences

    @property
    def primary_orth(self) -> str:
        return self.orth[0] if self.orth else ""

    def synt_tokens(self) -> List[str]:
        """LM tokens for this lemma (defaults to the primary orth)."""
        if self.synt is not None:
            return self.synt
        return [self.primary_orth] if self.orth else []

    def eval_tokens(self) -> List[str]:
        """Scoring tokens (defaults to primary orth; empty for e.g. silence)."""
        if self.evals is not None:
            return self.evals[0] if self.evals else []
        return [self.primary_orth] if self.orth else []


class Lexicon:
    """Phoneme inventory + lemmata with orth and pronunciation variants."""

    def __init__(self) -> None:
        self.phonemes = PhonemeInventory()
        self.lemmata: List[Lemma] = []
        self._by_orth: Dict[str, List[Lemma]] = {}
        self._special: Dict[str, Lemma] = {}

    # ----------------------------------------------------------------- build
    def add_lemma(
        self,
        orth: Sequence[str],
        prons: Sequence[Tuple[Sequence[str], float]],
        special: Optional[str] = None,
        synt: Optional[Sequence[str]] = None,
        evals: Optional[Sequence[Sequence[str]]] = None,
    ) -> Lemma:
        pron_objs = [
            Pronunciation(tuple(self.phonemes.add(p).id for p in symbols), score)
            for symbols, score in prons
        ]
        lemma = Lemma(
            id=len(self.lemmata),
            orth=list(orth),
            pronunciations=pron_objs,
            special=special,
            synt=list(synt) if synt is not None else None,
            evals=[list(e) for e in evals] if evals is not None else None,
        )
        self.lemmata.append(lemma)
        for o in lemma.orth:
            self._by_orth.setdefault(o, []).append(lemma)
        if special:
            self._special[special] = lemma
        return lemma

    # ----------------------------------------------------------------- parse
    @classmethod
    def load(cls, path: str) -> "Lexicon":
        root = parse_xml(path).getroot()
        if root.tag != "lexicon":
            raise ValueError(f"{path}: root element must be <lexicon>")
        lex = cls()
        inv = root.find("phoneme-inventory")
        if inv is not None:
            for ph in inv.findall("phoneme"):
                symbol = (ph.findtext("symbol") or "").strip()
                variation = (ph.findtext("variation") or "context").strip()
                lex.phonemes.add(symbol, context_independent=(variation == "none"))
        for lemma_elem in root.findall("lemma"):
            orth = [
                " ".join((o.text or "").split())
                for o in lemma_elem.findall("orth")
            ]
            prons: List[Tuple[List[str], float]] = []
            for ph_elem in lemma_elem.findall("phon"):
                symbols = (ph_elem.text or "").split()
                score = float(ph_elem.get("score", "0"))
                prons.append((symbols, score))
            synt = None
            synt_elem = lemma_elem.find("synt")
            if synt_elem is not None:
                synt = [
                    (t.text or "").strip() for t in synt_elem.findall("tok")
                ]
            evals = None
            eval_elems = lemma_elem.findall("eval")
            if eval_elems:
                evals = []
                for ev in eval_elems:
                    toks = [(t.text or "").strip() for t in ev.findall("tok")]
                    if not toks and (ev.text or "").strip():
                        toks = (ev.text or "").split()
                    evals.append(toks)
            lex.add_lemma(orth, prons, lemma_elem.get("special"), synt, evals)
        return lex

    # ------------------------------------------------------------------- api
    def lookup_orth(self, orth: str) -> List[Lemma]:
        return self._by_orth.get(orth, [])

    def special(self, kind: str) -> Optional[Lemma]:
        return self._special.get(kind)

    @property
    def silence(self) -> Optional[Lemma]:
        return self._special.get("silence")

    @property
    def unknown(self) -> Optional[Lemma]:
        return self._special.get("unknown")

    def num_pronunciations(self) -> int:
        return sum(len(l.pronunciations) for l in self.lemmata)

    def words_with_pronunciations(self) -> List[Lemma]:
        """Lemmata usable in decoding (have ≥1 pronunciation)."""
        return [l for l in self.lemmata if l.pronunciations]


def build_default_silence(lex: Lexicon, symbol: str = "[SILENCE]", phoneme: str = "si") -> Lemma:
    """Ensure a silence lemma exists (context-independent single phoneme)."""
    if lex.silence is not None:
        return lex.silence
    lex.phonemes.add(phoneme, context_independent=True)
    return lex.add_lemma([symbol], [([phoneme], 0.0)], special="silence", synt=[], evals=[[]])
