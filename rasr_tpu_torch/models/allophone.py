"""Allophones (context-dependent phones) and their state alphabet.

Re-implements the reference's allophone machinery
(ref: src/Am/ClassicAcousticModel.*, Am::Allophone,
Am::AllophoneStateAlphabet): an allophone is a phoneme in a left/right
phonetic context with word-boundary flags; an allophone *state* adds the
HMM state index. The reference interns allophones in an alphabet of
packed ids — here ids are packed int64s computed arithmetically so any
(center, left, right, flags, state) maps to a stable id without a table,
which is what lets state-tying tables live in dense device arrays.

Context width is 1 on each side (triphones), the reference's standard
configuration; context-independent phonemes (silence) always use empty
context.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

from ..corpus.lexicon import Lexicon

#: id 0 is the empty/no-context marker on either side
NO_CONTEXT = 0

FLAG_INITIAL = 1  # allophone at word begin (ref: Am::Allophone::isInitialPhone)
FLAG_FINAL = 2  # allophone at word end


@dataclasses.dataclass(frozen=True)
class Allophone:
    center: int  # phoneme id (1-based)
    left: int = NO_CONTEXT
    right: int = NO_CONTEXT
    boundary: int = 0  # FLAG_INITIAL | FLAG_FINAL

    def format(self, lex: Lexicon) -> str:
        def sym(pid):
            return lex.phonemes.by_id(pid).symbol if pid else "#"

        flags = ("@i" if self.boundary & FLAG_INITIAL else "") + (
            "@f" if self.boundary & FLAG_FINAL else ""
        )
        return f"{sym(self.center)}{{{sym(self.left)}+{sym(self.right)}}}{flags}"


@dataclasses.dataclass(frozen=True)
class AllophoneState:
    allophone: Allophone
    state: int  # HMM emitting state index (0-based)

    def format(self, lex: Lexicon) -> str:
        return f"{self.allophone.format(lex)}.{self.state}"


class AllophoneAlphabet:
    """Arithmetic packing of allophone states into int64 ids.

    id = ((center * P1 + left) * P1 + right) * 4 + boundary) * S + state
    with P1 = num_phonemes + 1 (for the empty-context marker) and
    S = max states per phone. Dense enough for gather tables keyed by id
    hashing, stable across runs, no interning needed.
    """

    def __init__(self, lexicon: Lexicon, max_states: int = 3):
        self.lexicon = lexicon
        self.num_phonemes = len(lexicon.phonemes)
        self.p1 = self.num_phonemes + 1
        self.max_states = max_states

    def index(self, a: AllophoneState) -> int:
        al = a.allophone
        return (
            ((al.center * self.p1 + al.left) * self.p1 + al.right) * 4 + al.boundary
        ) * self.max_states + a.state

    def unpack(self, idx: int) -> AllophoneState:
        state = idx % self.max_states
        idx //= self.max_states
        boundary = idx % 4
        idx //= 4
        right = idx % self.p1
        idx //= self.p1
        left = idx % self.p1
        center = idx // self.p1
        return AllophoneState(Allophone(center, left, right, boundary), state)

    @property
    def size_bound(self) -> int:
        return ((self.num_phonemes + 1) ** 3) * 4 * self.max_states

    # ------------------------------------------------------------- expansion
    def phone_states(
        self, pid: int, left: int, right: int, topology, boundary: int = 0
    ) -> List[AllophoneState]:
        """States of ONE phone occurrence with explicit raw neighbors.

        Applies the same context rules as :meth:`phone_sequence_states`
        (ci centers take empty context; ci neighbors break context) —
        used by the across-word search-network compiler, which expands
        edge phones per (left, right) context variant."""
        lex = self.lexicon
        ph = lex.phonemes.by_id(pid)
        if ph.context_independent:
            left = right = NO_CONTEXT
        else:
            if left and lex.phonemes.by_id(left).context_independent:
                left = NO_CONTEXT
            if right and lex.phonemes.by_id(right).context_independent:
                right = NO_CONTEXT
        allo = Allophone(pid, left, right, boundary)
        return [
            AllophoneState(allo, topology.emitting_state_index(s))
            for s in range(topology.num_states(ph.context_independent))
        ]

    def phone_sequence_states(
        self,
        phonemes: Sequence[int],
        topology,
        across_word_left: int = NO_CONTEXT,
        across_word_right: int = NO_CONTEXT,
    ) -> List[AllophoneState]:
        """Expand a pronunciation into its allophone state sequence.

        Context-independent phonemes take empty context and also act as
        context breaks for their neighbors (reference behavior: silence
        does not propagate context).
        """
        lex = self.lexicon
        out: List[AllophoneState] = []
        n = len(phonemes)
        for i, pid in enumerate(phonemes):
            ph = lex.phonemes.by_id(pid)
            if ph.context_independent:
                left = right = NO_CONTEXT
            else:
                left = phonemes[i - 1] if i > 0 else across_word_left
                right = phonemes[i + 1] if i < n - 1 else across_word_right
                if left and lex.phonemes.by_id(left).context_independent:
                    left = NO_CONTEXT
                if right and lex.phonemes.by_id(right).context_independent:
                    right = NO_CONTEXT
            boundary = (FLAG_INITIAL if i == 0 else 0) | (FLAG_FINAL if i == n - 1 else 0)
            allo = Allophone(pid, left, right, boundary)
            for s in range(topology.num_states(ph.context_independent)):
                out.append(AllophoneState(allo, topology.emitting_state_index(s)))
        return out
