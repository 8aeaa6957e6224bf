"""Orthography -> linear HMM alignment graphs (host numpy).

The port's copy of ``rasr_tpu/align/graph.py``, over the port's own
lexicon, allophone, HMM and tying modules. It replaces the reference's
per-utterance alignment transducer construction
(ref: src/Am/TransducerBuilder.*, src/Speech/Aligner.* — orth acceptor ∘
lemma-pronunciation ∘ allophone-state HMM with TDPs, built as a lazy FSA).
A fixed pronunciation with optional inter-word silence yields a *linear*
chain whose only transitions are loop / forward / skip — exactly the
bandwidth-3 structure ops/viterbi.py consumes as dense arrays — so graph
building is pure host-side numpy and the DP itself never touches an FSA.

Conventions for transition costs (matching the reference's TDP semantics):
* entering state j from j-1 costs the *leave* penalty of j-1: its class's
  ``exit`` if j-1 ends a word, else ``forward``;
* entering j from j-2 costs either the bypass penalty (leave of j-2) when
  j-1 is an optional silence state, or the ``skip`` penalty of j-2's
  class for a within-word skip;
* looping in j costs its class's ``loop``;
* ending in j costs its class's ``exit``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..corpus.lexicon import Lemma, Lexicon, Pronunciation
from ..models.allophone import AllophoneAlphabet, AllophoneState
from ..models.hmm import HmmTopology, TransitionModel
from ..models.tying import StateTying
from ..ops.viterbi import BIG


class OrthographyError(ValueError):
    pass


def orth_to_lemmas(
    orth: str, lexicon: Lexicon, allow_unknown: bool = True
) -> List[Lemma]:
    """Tokenize an orthography into lemmata (ref: Bliss::OrthographicParser).

    Unknown words map to the lexicon's [UNKNOWN] lemma if present."""
    lemmas: List[Lemma] = []
    for token in orth.split():
        cands = lexicon.lookup_orth(token)
        if not cands:
            unk = lexicon.unknown
            if unk is not None and allow_unknown and unk.pronunciations:
                lemmas.append(unk)
                continue
            raise OrthographyError(f"no lexicon entry for {token!r}")
        lemmas.append(cands[0])
    return lemmas


@dataclasses.dataclass
class LinearGraph:
    """Dense banded-DP arrays plus labels for one utterance."""

    emission_ids: np.ndarray  # [S] int32 tied-class per chain state
    loop: np.ndarray  # [S] f32
    fwd: np.ndarray  # [S] f32
    skip: np.ndarray  # [S] f32
    init: np.ndarray  # [S] f32 (0 at start states, BIG else)
    final: np.ndarray  # [S] f32 (exit cost at allowed end states, BIG else)
    states: List[AllophoneState]  # per chain state
    lemma_of_state: np.ndarray  # [S] int32 index into `lemmas` (-1 = silence)
    lemmas: List[Lemma]

    @property
    def num_states(self) -> int:
        return self.emission_ids.shape[0]


def build_linear_graph(
    orth: str,
    lexicon: Lexicon,
    tying: StateTying,
    topology: HmmTopology = HmmTopology(),
    transitions: TransitionModel = TransitionModel(),
    optional_silence: bool = True,
    pronunciation_index: int = 0,
    allow_unknown: bool = True,
    across_word: bool = False,
) -> LinearGraph:
    """``across_word=True`` expands word-boundary phones with their true
    cross-word triphone contexts (the neighboring word's edge phone; ci
    neighbors such as silence break context to ``#`` as always). Only
    valid with ``optional_silence=False``: with optional silences the
    junction context would depend on the alignment path, which a linear
    chain cannot represent — put silence in the orthography explicitly
    (matching the across-word search network's committed contexts)."""
    if across_word and optional_silence:
        raise ValueError(
            "across_word requires optional_silence=False "
            "(junction contexts must be path-independent)"
        )
    lemmas = orth_to_lemmas(orth, lexicon, allow_unknown)
    if not lemmas:
        raise OrthographyError(f"empty orthography {orth!r}")
    sil = lexicon.silence
    alphabet = AllophoneAlphabet(
        lexicon, max_states=max(topology.states_per_phone, topology.silence_states)
    )

    chain: List[AllophoneState] = []
    is_sil: List[bool] = []  # optional-silence flag per chain state
    word_end: List[bool] = []  # leave-with-exit flag per chain state
    lemma_idx: List[int] = []

    def push_silence():
        if sil is None or not sil.pronunciations or not optional_silence:
            return
        states = alphabet.phone_sequence_states(sil.pronunciations[0].phonemes, topology)
        for k, st in enumerate(states):
            chain.append(st)
            is_sil.append(True)
            word_end.append(k == len(states) - 1)
            lemma_idx.append(-1)

    def pron_of(lemma: Lemma, w: int = 0) -> Pronunciation:
        if not lemma.pronunciations:
            raise OrthographyError(f"lemma {lemma.primary_orth!r} has no pronunciation")
        # pronunciation_index: a single int (same variant for every
        # lemma, clamped) or a per-lemma sequence (lattice/rescore.py
        # sweeps the variant cross product of multi-word arcs)
        if isinstance(pronunciation_index, (list, tuple)):
            idx = pronunciation_index[w]
        else:
            idx = pronunciation_index
        return lemma.pronunciations[min(idx, len(lemma.pronunciations) - 1)]

    push_silence()
    for w, lemma in enumerate(lemmas):
        pron = pron_of(lemma, w)
        left = right = 0
        if across_word:
            # true junction contexts: the neighbor's edge phone (ci
            # neighbors break to # inside phone_sequence_states)
            if w > 0:
                left = pron_of(lemmas[w - 1], w - 1).phonemes[-1]
            if w + 1 < len(lemmas):
                right = pron_of(lemmas[w + 1], w + 1).phonemes[0]
        states = alphabet.phone_sequence_states(
            pron.phonemes, topology,
            across_word_left=left, across_word_right=right,
        )
        for k, st in enumerate(states):
            chain.append(st)
            is_sil.append(False)
            word_end.append(k == len(states) - 1)
            lemma_idx.append(w)
        push_silence()

    S = len(chain)
    emission_ids = np.array([tying.classify(st) for st in chain], np.int32)

    def cls_tdp(i: int):
        ph = lexicon.phonemes.by_id(chain[i].allophone.center)
        return transitions.for_class(ph.context_independent)

    def leave(i: int) -> float:
        tdp = cls_tdp(i)
        return tdp.exit if word_end[i] else tdp.forward

    loop = np.empty(S, np.float32)
    fwd = np.full(S, BIG, np.float32)
    skip = np.full(S, BIG, np.float32)
    for j in range(S):
        loop[j] = min(cls_tdp(j).loop, BIG)
        if j >= 1:
            fwd[j] = min(leave(j - 1), BIG)
        if j >= 2:
            if is_sil[j - 1] and not is_sil[j - 2] and not is_sil[j]:
                # bypass a single-state optional silence entirely (longer
                # silence chains are not skippable mid-way)
                skip[j] = min(leave(j - 2), BIG)
            else:
                # within-word skip (disabled when tdp skip = inf)
                same_word = lemma_idx[j] == lemma_idx[j - 2] and not is_sil[j - 2]
                if same_word and not word_end[j - 1]:
                    skip[j] = min(cls_tdp(j - 2).skip, BIG)

    init = np.full(S, BIG, np.float32)
    init[0] = 0.0
    if is_sil[0] and 1 < S:
        # silence chains at utterance start are optional: allow starting
        # right at the first real word state
        first_word = next(i for i in range(S) if not is_sil[i])
        init[first_word] = 0.0

    final = np.full(S, BIG, np.float32)
    final[S - 1] = min(cls_tdp(S - 1).exit, BIG)
    if is_sil[S - 1]:
        last_word = next(i for i in range(S - 1, -1, -1) if not is_sil[i])
        final[last_word] = min(cls_tdp(last_word).exit, BIG)

    return LinearGraph(
        emission_ids=emission_ids,
        loop=loop,
        fwd=fwd,
        skip=skip,
        init=init,
        final=final,
        states=chain,
        lemma_of_state=np.array(lemma_idx, np.int32),
        lemmas=lemmas,
    )
