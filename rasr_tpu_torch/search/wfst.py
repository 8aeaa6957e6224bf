"""Generic WFST decoding: compile an automaton into the decoder tables.

Covers the role of the reference's WFST decoder
(ref: src/Search/Wfst/ [MODULE_SEARCH_WFST] — decoding over statically
composed transducers instead of the lexical prefix tree). Instead of a
separate search implementation, any search network expressed as an
emission-labeled transducer compiles into the SAME :class:`PrefixTree`
array format the vectorized token-passing decoder consumes — one search
kernel, two network compilers (TPU-native separation: the kernel is
network-agnostic, networks are data).

Transducer convention (an "HC-level" machine):
* arc ilabel = emission class id + 1 (0 = epsilon structural arc,
  removed at compile);
* arc olabel = output word: lemma index + 1 (0 = none);
* arc weight = transition cost (TDPs etc. pre-folded);
* frame consumption: each emitting arc becomes a decode state with a
  self-loop (``loop_cost``).

Word-emitting arcs complete through the decoder's word-end machinery and
re-enter at a non-emitting *junction* state of their target node
(``we_next``); non-emitting junctions are only reachable that way, so
they never collect emission scores — exactly like the prefix tree's
root. Arcs into final nodes additionally get a word-end slot re-entering
the root with the final weight, which is how the decoder recognizes
completed paths. Use a zerogram table for pure-grammar decoding, or map
``lm_words`` to score word outputs with a real LM.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fsa.automaton import EPS, Automaton
from ..ops.viterbi import BIG
from .tree import WORD_NONE, WORD_SILENCE, PrefixTree


def compile_wfst(
    fsa: Automaton,
    num_classes: int,
    lemmas: Sequence,
    loop_cost: float = 0.0,
    lm_words: Optional[Dict[int, int]] = None,
) -> PrefixTree:
    """Automaton -> decoder arrays (see module docstring for labeling)."""
    from ..fsa.algorithms import remove_epsilon

    nfa = remove_epsilon(fsa)

    arcs = []  # (src, tgt, cls, word_out, weight)
    for s in range(nfa.num_states):
        for a in nfa.arcs[s]:
            if a.ilabel == EPS:
                continue
            arcs.append((s, a.target, a.ilabel - 1, a.olabel - 1, a.weight))
    A = len(arcs)
    by_src: Dict[int, List[int]] = {}
    for i, (s, *_rest) in enumerate(arcs):
        by_src.setdefault(s, []).append(i)

    # ---- decode state allocation: 0 root, then arcs, then junctions ----
    arc_state = {i: 1 + i for i in range(A)}
    junction: Dict[int, int] = {}  # automaton node -> junction decode state
    next_id = [1 + A]

    def get_junction(node: int) -> int:
        if node not in junction:
            junction[node] = next_id[0]
            next_id[0] += 1
        return junction[node]

    # first pass: create junctions for word-emitting arc targets
    for s, t, cls, w, wt in arcs:
        if w >= 0 and by_src.get(t):
            get_junction(t)

    S = next_id[0]
    emission_class = np.zeros(S, np.int32)
    loop = np.full(S, BIG, np.float32)
    out_arcs: List[List[Tuple[int, float]]] = [[] for _ in range(S)]
    word_ends: List[List[Tuple[int, float, int, int]]] = [[] for _ in range(S)]

    for i, (s, t, cls, w, wt) in enumerate(arcs):
        st = arc_state[i]
        emission_class[st] = cls
        loop[st] = loop_cost
        if w >= 0:
            lm_w = (lm_words or {}).get(w, WORD_SILENCE)
            if by_src.get(t):
                word_ends[st].append((lm_w, 0.0, w, junction[t]))
            if t in nfa.finals:
                word_ends[st].append((lm_w, nfa.finals[t], w, 0))
        else:
            # silent completion: direct transitions to successors
            for j in by_src.get(t, []):
                out_arcs[st].append((arc_state[j], arcs[j][4]))
            if t in nfa.finals:
                # path may end here without a word: epsilon word-end
                word_ends[st].append((WORD_SILENCE, nfa.finals[t], -1, 0))

    # junction expansion = successors of the node
    for node, jst in junction.items():
        for j in by_src.get(node, []):
            out_arcs[jst].append((arc_state[j], arcs[j][4]))

    # root = initial node's arcs
    for j in by_src.get(nfa.initial, []):
        out_arcs[0].append((arc_state[j], arcs[j][4]))

    # ---- flatten (same layout as build_prefix_tree) --------------------
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
            flat_cost.append(min(cost, BIG))
        arc_ptr[s + 1] = len(flat_dst)

    w_max = max(1, max((len(w) for w in word_ends), default=1))
    we_word = np.full((S, w_max), WORD_NONE, np.int32)
    we_cost = np.full((S, w_max), np.float32(BIG), np.float32)
    we_lemma = np.full((S, w_max), -1, np.int32)
    we_next = np.zeros((S, w_max), np.int32)
    for s, ws in enumerate(word_ends):
        # INVARIANT (shared with tree._flatten_tree): slots sorted by
        # cost ascending — the decoder's two-stage word-end top-R
        # (search/decoder.py, wmax > 1) is exact only under this ordering
        ws = sorted(ws, key=lambda w: w[1])
        for k, (lm_w, cost, lemma, nxt) in enumerate(ws[:w_max]):
            we_word[s, k] = lm_w
            we_cost[s, k] = min(cost, BIG)
            we_lemma[s, k] = lemma
            we_next[s, k] = nxt

    return PrefixTree(
        emission_class=emission_class,
        loop_cost=loop,
        arc_ptr=arc_ptr,
        arc_dst=np.asarray(flat_dst, np.int32) if flat_dst else np.zeros(0, np.int32),
        arc_cost=np.asarray(flat_cost, np.float32) if flat_cost else np.zeros(0, np.float32),
        we_word=we_word,
        we_cost=we_cost,
        we_lemma=we_lemma,
        lemmas=list(lemmas),
        max_out_degree=max_deg,
        we_next=we_next,
    )
