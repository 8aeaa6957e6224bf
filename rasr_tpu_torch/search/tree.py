"""Lexical prefix tree compiled to dense decode arrays (within-word).

A JAX-free copy of the within-word builder of ``rasr_tpu/search/tree.py``
(``PrefixTree``, ``build_prefix_tree``, ``_flatten_tree``,
``_lm_word_of``, ``compute_lookahead``), held equal to it field by field
by ``tests/test_torch_tree.py``. The reference module reaches jax only
through its ``BIG`` constant (imported from ``ops/viterbi.py``); this
copy defines ``BIG`` locally and goes away once ``BIG`` moves out of
``ops/viterbi.py`` and the port can import the reference builder without
jax. The across-word network (``across_word=True``) is not ported yet.

Tree nodes are phone arcs (word-internal triphones; word-boundary
contexts use the ``#`` approximation), shared across words with the same
(tree position, tied-class signature). State 0 is the non-emitting root:
word-end re-entry hypotheses sit there and expand into first-phone
states on the next frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from rasr_tpu.corpus.lexicon import Lexicon
from rasr_tpu.models.allophone import AllophoneAlphabet
from rasr_tpu.models.hmm import HmmTopology, TransitionModel
from rasr_tpu.models.tying import StateTying

BIG = 1.0e30  # the reference's "infinite" cost (rasr_tpu/ops/viterbi.py)

WORD_NONE = -1
WORD_SILENCE = -2  # word without LM tokens (silence and friends)


@dataclasses.dataclass
class PrefixTree:
    emission_class: np.ndarray  # [S] i32
    loop_cost: np.ndarray  # [S] f32
    arc_ptr: np.ndarray  # [S+1] i32 (CSR over out-arcs)
    arc_dst: np.ndarray  # [A] i32
    arc_cost: np.ndarray  # [A] f32
    we_word: np.ndarray  # [S, Wmax] i32
    we_cost: np.ndarray  # [S, Wmax] f32
    we_lemma: np.ndarray  # [S, Wmax] i32
    lemmas: List  # lemma objects by index used in we_lemma
    max_out_degree: int
    #: unigram LM lookahead potential per state (min unscaled unigram LM
    #: cost over word ends reachable in the subtree; 0 everywhere when no
    #: unigram table was provided at build). ref: src/Search/LmLookahead —
    #: folded into pruning via exact potential shaping in the decoder.
    lookahead: Optional[np.ndarray] = None
    #: word-end re-entry state per (state, word-end slot). None = all 0
    #: (the prefix tree's root). Generic WFST networks re-enter at
    #: non-emitting junction states instead (search/wfst.py), and the
    #: across-word network re-enters at context-conditioned roots.
    we_next: Optional[np.ndarray] = None
    #: states [0, num_final_states) accept complete hypotheses (utterance
    #: may end there). The within-word tree has exactly one such state
    #: (the root); the across-word network also accepts its
    #: boundary-committed root (state 1).
    num_final_states: int = 1

    @property
    def num_states(self) -> int:
        return self.emission_class.shape[0]

    @property
    def num_arcs(self) -> int:
        return self.arc_dst.shape[0]

    @property
    def max_word_ends(self) -> int:
        return self.we_word.shape[1]

    def stats(self) -> Dict[str, int]:
        return {
            "states": self.num_states,
            "arcs": self.num_arcs,
            "max_out_degree": self.max_out_degree,
            "max_word_ends": self.max_word_ends,
            "word_end_states": int((self.we_word[:, 0] != WORD_NONE).sum()),
        }


def build_prefix_tree(
    lexicon: Lexicon,
    tying: StateTying,
    topology: HmmTopology = HmmTopology(),
    transitions: TransitionModel = TransitionModel(),
    lm_vocab: Optional[Dict[str, int]] = None,
    within_phone_skip: bool = True,
    lm_unigrams: Optional[Dict[int, float]] = None,
    across_word: bool = False,
    skip_scope: str = "word",
) -> PrefixTree:
    """Compile the decoding network from the lexicon.

    ``lm_vocab`` maps syntactic tokens to LM word ids; lemmas whose first
    synt token is missing from it decode via <unk> if present, else are
    scored as no-LM words. ``lm_unigrams`` (LM word id -> unscaled -log
    unigram cost) enables the lookahead potential.

    ``across_word=True`` (the reference's across-word network with exact
    word-boundary triphone contexts) is not ported yet and raises.

    ``skip_scope`` controls which finite-skip TDP transitions the network
    realizes (``within_phone_skip=False`` disables skips entirely):

    * ``"word"`` (default): skips connect state j-2 -> j over each WORD's
      whole state chain, crossing phone boundaries — the reference's
      topology (its transducers apply TDPs over the expanded
      pronunciation state sequence) and exactly what the alignment
      graphs do (align/graph.py), so alignment and decode scores agree.
    * ``"phone"``: skips stay within each phone's states (the leaner
      historical network of this repo's benchmarks: boundary skip arcs
      roughly double junction fan-out, which widens the decoder's
      branch-overflow sections; with skip = inf both scopes coincide).
    """
    if skip_scope not in ("word", "phone"):
        raise ValueError(f"unknown skip_scope {skip_scope!r}")
    if across_word:
        raise NotImplementedError("the across-word network is not ported yet")
    alphabet = AllophoneAlphabet(
        lexicon, max_states=max(topology.states_per_phone, topology.silence_states)
    )
    unk_id = lm_vocab.get("<unk>") if lm_vocab else None

    # ---- states ----------------------------------------------------------
    emission_class: List[int] = [0]  # root placeholder
    loop_cost: List[float] = [BIG]
    out_arcs: List[List[Tuple[int, float]]] = [[]]  # per state
    word_ends: List[List[Tuple[int, float, int]]] = [[]]

    def new_state(cls: int, loop: float) -> int:
        emission_class.append(cls)
        loop_cost.append(min(loop, BIG))
        out_arcs.append([])
        word_ends.append([])
        return len(emission_class) - 1

    # arc sharing: (parent_node, signature) -> (child_node, state ids)
    arc_map: Dict[Tuple[int, Tuple], Tuple[int, List[int]]] = {}
    next_node = [1]  # node ids (root=0); nodes are virtual (arcs carry states)

    lemma_list: List = []

    for lemma in lexicon.lemmata:
        if not lemma.pronunciations:
            continue
        synt = lemma.synt_tokens()
        if not synt:
            lm_word = WORD_SILENCE
        elif lm_vocab is None:
            lm_word = WORD_SILENCE if lemma.special == "silence" else 0
        else:
            lm_word = lm_vocab.get(synt[0], unk_id if unk_id is not None else WORD_SILENCE)
        lemma_idx = len(lemma_list)
        lemma_list.append(lemma)

        for pron in lemma.pronunciations:
            states_flat = alphabet.phone_sequence_states(pron.phonemes, topology)
            # group chain entries by phone position
            per_phone: List[List] = []
            pos = 0
            for i, pid in enumerate(pron.phonemes):
                ph = lexicon.phonemes.by_id(pid)
                n = topology.num_states(ph.context_independent)
                per_phone.append(states_flat[pos : pos + n])
                pos += n

            cur_node = 0
            prev_last_state = 0  # root
            prev_leave_cost = 0.0  # cost of arc from prev into this arc's head
            chain: List[Tuple[int, float]] = []  # (state, skip cost of its phone)
            for i, phone_states in enumerate(per_phone):
                ph = lexicon.phonemes.by_id(pron.phonemes[i])
                tdp = transitions.for_class(ph.context_independent)
                classes = tuple(tying.classify(st) for st in phone_states)
                key = (cur_node, classes)
                if key in arc_map:
                    child_node, sids = arc_map[key]
                else:
                    sids = [new_state(c, tdp.loop) for c in classes]
                    # chain transitions within the phone
                    for j in range(len(sids) - 1):
                        out_arcs[sids[j]].append((sids[j + 1], min(tdp.forward, BIG)))
                    if skip_scope == "phone" and within_phone_skip and tdp.skip < BIG:
                        for j in range(len(sids) - 2):
                            out_arcs[sids[j]].append((sids[j + 2], tdp.skip))
                    child_node = next_node[0]
                    next_node[0] += 1
                    arc_map[key] = (child_node, sids)
                # connect parent tail to this arc's head (flatten dedups)
                out_arcs[prev_last_state].append((sids[0], min(prev_leave_cost, BIG)))
                cur_node = child_node
                prev_last_state = sids[-1]
                prev_leave_cost = tdp.forward
                chain.extend((s, tdp.skip) for s in sids)

            if skip_scope == "word" and within_phone_skip:
                # skip transitions over the WHOLE word state chain (j-2 -> j,
                # crossing phone boundaries — matching the alignment graphs
                # and the reference's transducer topology); shared arcs
                # re-add identical skips, the flatten dedups them
                for j in range(2, len(chain)):
                    src, skip_cost = chain[j - 2]
                    if skip_cost < BIG:
                        out_arcs[src].append((chain[j][0], skip_cost))

            final_ph = lexicon.phonemes.by_id(pron.phonemes[-1])
            final_tdp = transitions.for_class(final_ph.context_independent)
            we_cost = min(final_tdp.exit + pron.score, BIG)
            word_ends[prev_last_state].append((lm_word, we_cost, lemma_idx, 0))

    tree = _flatten_tree(emission_class, loop_cost, out_arcs, word_ends, lemma_list)
    if lm_unigrams is not None:
        tree.lookahead = compute_lookahead(tree, lm_unigrams)
    return tree


def _flatten_tree(
    emission_class: List[int],
    loop_cost: List[float],
    out_arcs: List[List[Tuple[int, float]]],
    word_ends: List[List[Tuple[int, float, int, int]]],
    lemma_list: List,
    num_final_states: int = 1,
) -> PrefixTree:
    """Host lists -> dense decode arrays (the reference shares this with its
    across-word network builder).

    Word-end entries are (lm_word, cost, lemma_idx, re-entry state); arcs
    with the same destination dedup to the min cost."""
    S = len(emission_class)
    arc_ptr = np.zeros(S + 1, np.int32)
    flat_dst: List[int] = []
    flat_cost: List[float] = []
    max_deg = 0
    for s in range(S):
        best: Dict[int, float] = {}
        for dst, cost in out_arcs[s]:
            if dst not in best or cost < best[dst]:
                best[dst] = cost
        items = sorted(best.items())
        max_deg = max(max_deg, len(items))
        for dst, cost in items:
            flat_dst.append(dst)
            flat_cost.append(cost)
        arc_ptr[s + 1] = len(flat_dst)

    w_max = max(1, max(len(w) for w in word_ends))
    we_word = np.full((S, w_max), WORD_NONE, np.int32)
    we_cost_arr = np.full((S, w_max), np.float32(BIG), np.float32)
    we_lemma = np.full((S, w_max), -1, np.int32)
    we_next = np.zeros((S, w_max), np.int32)
    any_next = False
    for s, ws in enumerate(word_ends):
        # dedup identical (word, lemma, re-entry) keeping best cost
        seen: Dict[Tuple[int, int, int], float] = {}
        for w, c, l, nx in ws:
            if (w, l, nx) not in seen or c < seen[(w, l, nx)]:
                seen[(w, l, nx)] = c
        # INVARIANT: slots sorted by cost ascending — the decoder's
        # two-stage word-end top-R (search/decoder.py, wmax > 1 path)
        # is exact ONLY under this ordering (slot 0 bounds the rest)
        for k, ((w, l, nx), c) in enumerate(
            sorted(seen.items(), key=lambda kv: kv[1])
        ):
            we_word[s, k] = w
            we_cost_arr[s, k] = c
            we_lemma[s, k] = l
            we_next[s, k] = nx
            any_next = any_next or nx != 0

    return PrefixTree(
        emission_class=np.asarray(emission_class, np.int32),
        loop_cost=np.asarray(loop_cost, np.float32),
        arc_ptr=arc_ptr,
        arc_dst=np.asarray(flat_dst, np.int32),
        arc_cost=np.asarray(flat_cost, np.float32),
        we_word=we_word,
        we_cost=we_cost_arr,
        we_lemma=we_lemma,
        lemmas=lemma_list,
        max_out_degree=max_deg,
        we_next=we_next if any_next else None,
        num_final_states=num_final_states,
    )


def _lm_word_of(lemma, lm_vocab, unk_id) -> int:
    synt = lemma.synt_tokens()
    if not synt:
        return WORD_SILENCE
    if lm_vocab is None:
        return WORD_SILENCE if lemma.special == "silence" else 0
    return lm_vocab.get(synt[0], unk_id if unk_id is not None else WORD_SILENCE)


def compute_lookahead(tree: PrefixTree, lm_unigrams: Dict[int, float]) -> np.ndarray:
    """Per-state lookahead potential: min unscaled unigram cost over word
    ends reachable below each state (silence/no-LM words count as 0).

    States are created parent-before-child, so a single reverse sweep is
    a valid reverse-topological relaxation (loops/word-end re-entries are
    not tree arcs).
    """
    S = tree.num_states
    la = np.full(S, np.float32(BIG), np.float32)
    default = max(lm_unigrams.values()) if lm_unigrams else 0.0
    for s in range(S - 1, -1, -1):
        best = BIG
        for k in range(tree.max_word_ends):
            w = tree.we_word[s, k]
            if w == WORD_NONE:
                break
            best = min(best, 0.0 if w < 0 else lm_unigrams.get(int(w), default))
        for ai in range(tree.arc_ptr[s], tree.arc_ptr[s + 1]):
            best = min(best, float(la[tree.arc_dst[ai]]))
        la[s] = best
    la[la >= BIG / 2] = 0.0  # dead-end states (shouldn't exist): neutral
    return la.astype(np.float32)


# ------------------------------------------------------------- image caching
