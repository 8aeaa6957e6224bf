"""State tying: allophone states -> emission class ids.

Re-implements the reference's tying schemes
(ref: src/Am/ClassicStateTying.* — monophone / lut / cart / dense):
the tying decides which mixture (or NN output) an allophone state is
scored against. All tyings expose ``classify(AllophoneState) -> int`` and
``num_classes``; decoders/aligners bake the resulting class ids into
dense arrays, so tying runs host-side at graph-build time only.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from ..corpus.lexicon import Lexicon
from .allophone import AllophoneAlphabet, AllophoneState


class StateTying:
    num_classes: int

    def classify(self, state: AllophoneState) -> int:  # pragma: no cover
        raise NotImplementedError


class MonophoneStateTying(StateTying):
    """class = per-phoneme state block (context ignored).

    Context-independent phonemes contribute ``silence_states`` classes,
    others ``states_per_phone`` (ref: Am::MonophoneStateTying).
    """

    def __init__(self, lexicon: Lexicon, topology):
        self.lexicon = lexicon
        self.topology = topology
        self._offset: Dict[int, int] = {}
        ofs = 0
        for ph in lexicon.phonemes:
            self._offset[ph.id] = ofs
            ofs += (
                topology.silence_states
                if ph.context_independent
                else topology.states_per_phone
            )
        self.num_classes = ofs

    def classify(self, state: AllophoneState) -> int:
        return self._offset[state.allophone.center] + state.state


class LutStateTying(StateTying):
    """Explicit lookup table keyed by packed allophone-state id
    (ref: Am::LutStateTying)."""

    def __init__(self, alphabet: AllophoneAlphabet, table: Dict[int, int]):
        self.alphabet = alphabet
        self.table = dict(table)
        self.num_classes = (max(table.values()) + 1) if table else 0

    def classify(self, state: AllophoneState) -> int:
        return self.table[self.alphabet.index(state)]

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({str(k): v for k, v in self.table.items()}, fh)

    @classmethod
    def load(cls, alphabet: AllophoneAlphabet, path: str) -> "LutStateTying":
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
        return cls(alphabet, {int(k): v for k, v in raw.items()})


class CartStateTying(StateTying):
    """Decision-tree tying (ref: Am::CartStateTying): classification
    delegates to a trained CART (models/cart.py)."""

    def __init__(self, tree, lexicon: Lexicon):
        self.tree = tree
        self.lexicon = lexicon
        self.num_classes = tree.num_classes

    def classify(self, state: AllophoneState) -> int:
        return self.tree.classify_allophone_state(state, self.lexicon)
