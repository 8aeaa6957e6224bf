"""Word lattices.

Re-implements the reference's lattice layer (ref: src/Lattice/Lattice.*,
Lattice::WordLattice with separate am/lm score dimensions and word
boundaries; built by the decoders via the word-pair approximation).

A lattice is a DAG: nodes carry (frame, lm-context) — merging decoder
traceback records that end at the same frame in the same LM context IS
the word-pair/word-conditioned lattice construction — and arcs carry
(lemma, am score, lm score). Construction consumes the decoder's fixed-
shape per-frame record buffers (search/decoder.py) on the host.

Lattices serialize into cache archives (utils/archive.py), mirroring the
reference's lattice archives.

The port's copy of ``rasr_tpu/lattice/lattice.py``: the lattice, its
image and ``lattice_from_records`` as the reference has them;
:func:`decoder_lattice` reads a decode's own handle (its records, final
beams and ``</s>`` costs, copied to the host once per handle) where the
reference reads the decoder's last decode. The FSA bridge
(:func:`lattice_to_fsa` / :func:`fsa_to_lattice`) runs over the port's
copy of ``fsa/``.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BIG = 1.0e30


@dataclasses.dataclass
class LatticeArc:
    from_node: int
    to_node: int
    lemma: int  # index into lattice.lemma_orths (-1 = epsilon)
    am_score: float
    lm_score: float

    @property
    def score(self) -> float:
        return self.am_score + self.lm_score


@dataclasses.dataclass
class Lattice:
    """DAG with unique initial node 0; final nodes carry final scores."""

    num_nodes: int
    arcs: List[LatticeArc]
    node_time: np.ndarray  # [N] frame index of each node (word boundaries)
    final_scores: Dict[int, float]  # node -> sentence-end score
    lemma_orths: List[str]

    def out_arcs(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.num_nodes)]
        for i, a in enumerate(self.arcs):
            out[a.from_node].append(i)
        return out

    def in_arcs(self) -> List[List[int]]:
        inn: List[List[int]] = [[] for _ in range(self.num_nodes)]
        for i, a in enumerate(self.arcs):
            inn[a.to_node].append(i)
        return inn

    def topological_order(self) -> List[int]:
        indeg = [0] * self.num_nodes
        for a in self.arcs:
            indeg[a.to_node] += 1
        out = self.out_arcs()
        stack = [n for n in range(self.num_nodes) if indeg[n] == 0]
        order = []
        while stack:
            n = stack.pop()
            order.append(n)
            for ai in out[n]:
                t = self.arcs[ai].to_node
                indeg[t] -= 1
                if indeg[t] == 0:
                    stack.append(t)
        if len(order) != self.num_nodes:
            raise ValueError("lattice has a cycle")
        return order

    # ------------------------------------------------------------------- io
    def pack(self) -> bytes:
        head = {
            "num_nodes": self.num_nodes,
            "node_time": self.node_time.tolist(),
            "final_scores": {str(k): v for k, v in self.final_scores.items()},
            "lemma_orths": self.lemma_orths,
        }
        hb = json.dumps(head).encode()
        arr = np.array(
            [
                (a.from_node, a.to_node, a.lemma, a.am_score, a.lm_score)
                for a in self.arcs
            ],
            dtype=np.float64,
        ).reshape(len(self.arcs), 5)
        return struct.pack("<I", len(hb)) + hb + arr.tobytes()

    @classmethod
    def unpack(cls, data: bytes) -> "Lattice":
        (hlen,) = struct.unpack_from("<I", data, 0)
        head = json.loads(data[4 : 4 + hlen].decode())
        arr = np.frombuffer(data, dtype=np.float64, offset=4 + hlen).reshape(-1, 5)
        arcs = [
            LatticeArc(int(r[0]), int(r[1]), int(r[2]), float(r[3]), float(r[4]))
            for r in arr
        ]
        return cls(
            num_nodes=head["num_nodes"],
            arcs=arcs,
            node_time=np.asarray(head["node_time"], np.int32),
            final_scores={int(k): v for k, v in head["final_scores"].items()},
            lemma_orths=head["lemma_orths"],
        )


def lattice_from_records(
    records: Tuple[np.ndarray, ...],
    b: int,
    R: int,
    lemmas: Sequence,
    finals: Tuple[np.ndarray, ...],
    n_frames: int,
    lm_end_scores: Optional[Dict[int, float]] = None,
    num_final_states: int = 1,
) -> Lattice:
    """Assemble the word lattice of utterance ``b`` from decoder records.

    records: (lemma, score, prev, lm_cost, word, lm_state) each [T, B, R].
    finals: (state, lm, score, bp, end_cost) each [B, K] — the final beam
    snapshot; root hyps define the lattice's final nodes, with the
    sentence-end LM cost as their final score.
    """
    rec_lemma, rec_score, rec_prev, rec_lmcost, rec_word, rec_lm = records
    T = rec_lemma.shape[0]
    fstate, flm, fscore, fbp, fend = finals

    # survivors: records reachable backwards from final root hyps
    live: Dict[int, None] = {}
    stack = []
    final_bps: List[Tuple[int, float, int]] = []  # (bp, end_cost, lm_state)
    for k in range(fstate.shape[1]):
        if fstate[b, k] < num_final_states and fscore[b, k] < BIG / 2 and fbp[b, k] >= 0:
            final_bps.append((int(fbp[b, k]), float(fend[b, k]), int(flm[b, k])))
            stack.append(int(fbp[b, k]))
    while stack:
        r = stack.pop()
        if r in live or r < 0:
            continue
        live[r] = None
        prev = int(rec_prev[r // R, b, r % R])
        if prev >= 0:
            stack.append(prev)

    # nodes: initial 0; then one per distinct (end_frame, lm_state)
    node_of: Dict[Tuple[int, int], int] = {}
    node_time = [0]

    def node(t: int, lm: int) -> int:
        key = (t, lm)
        if key not in node_of:
            node_of[key] = len(node_time)
            node_time.append(t)
        return node_of[key]

    lemma_orths = [l.primary_orth for l in lemmas]
    arcs: List[LatticeArc] = []
    for r in sorted(live):
        t, slot = r // R, r % R
        li = int(rec_lemma[t, b, slot])
        if li < 0:
            continue
        prev = int(rec_prev[t, b, slot])
        total = float(rec_score[t, b, slot])
        lm_cost = float(rec_lmcost[t, b, slot])
        lm_state = int(rec_lm[t, b, slot])
        if prev >= 0:
            pt, pslot = prev // R, prev % R
            src = node(pt, int(rec_lm[pt, b, pslot]))
            prev_total = float(rec_score[pt, b, pslot])
        else:
            src = 0
            prev_total = 0.0
        dst = node(t, lm_state)
        am = total - lm_cost - prev_total
        arcs.append(LatticeArc(src, dst, li, am, lm_cost))

    # final scores: sentence-end cost per final node
    final_scores: Dict[int, float] = {}
    for bp, end, lm_state in final_bps:
        t, slot = bp // R, bp % R
        nd = node(t, int(rec_lm[t, b, slot]))
        if lm_end_scores is not None:
            end = lm_end_scores.get(lm_state, end)
        final_scores[nd] = min(final_scores.get(nd, BIG), end)

    # dedup arcs (same src,dst,lemma keep min)
    best: Dict[Tuple[int, int, int], LatticeArc] = {}
    for a in arcs:
        key = (a.from_node, a.to_node, a.lemma)
        if key not in best or a.score < best[key].score:
            best[key] = a
    return Lattice(
        num_nodes=len(node_time),
        arcs=list(best.values()),
        node_time=np.asarray(node_time, np.int32),
        final_scores=final_scores,
        lemma_orths=lemma_orths,
    )


def decoder_lattice(handle, lemmas: Sequence, b: int = 0) -> Lattice:
    """Lattice of utterance ``b`` of a decode, from its
    ``search.decoder.DeviceDecode`` handle and the network's lemma list
    (``tree.lemmas``). The handle's records come to the host on the first
    call (``records_to_host``) and are reused for every utterance."""
    host = handle.records_to_host()
    return lattice_from_records(
        host.records, b, handle.word_end_limit, lemmas, host.finals,
        int(host.n_frames[b]), num_final_states=handle.num_final_states,
    )


# ------------------------------------------------------------ FSA bridge
def lattice_to_fsa(
    lat: Lattice, am_scale: float = 1.0, lm_scale: float = 1.0
):
    """Word lattice -> weighted acceptor over lemma labels.

    The reference's Flf layer IS an Fsa layer with extra score dimensions
    (ref: src/Flf/ builds on src/Fsa/); this bridge flattens the (am, lm)
    dimensions with the given scales so the full automata toolbox
    (fsa/algorithms: union, push, determinize, compose, n-best, ...)
    applies to lattices. Label i is lemma index i-1; epsilon arcs keep
    label 0. A super-final state absorbs per-node final scores.
    """
    from ..fsa.automaton import EPS, Automaton

    fsa = Automaton()
    for _ in range(lat.num_nodes + 1):
        fsa.add_state()
    fsa.initial = 0
    superfinal = lat.num_nodes
    for a in lat.arcs:
        label = 0 if a.lemma < 0 else a.lemma + 1
        fsa.add_arc(
            a.from_node, a.to_node, label,
            weight=am_scale * a.am_score + lm_scale * a.lm_score,
        )
    for nd, sc in lat.final_scores.items():
        fsa.add_arc(nd, superfinal, EPS, weight=sc)
    fsa.set_final(superfinal, 0.0)
    for i, orth in enumerate(lat.lemma_orths):
        fsa.input_symbols[i + 1] = orth
        fsa.output_symbols[i + 1] = orth
    return fsa


def fsa_to_lattice(fsa, lemma_orths: Optional[List[str]] = None) -> Lattice:
    """Weighted acceptor -> word lattice (inverse bridge).

    Weights land in the am dimension (lm = 0): after generic FSA
    processing the two-dimensional score split is gone, like the
    reference's single-dimension lattices after semiring projection.
    Node times are unknown post-transformation (-1).
    """
    # Lattice's contract fixes the initial node at 0; remap by swapping
    # state ids when the automaton starts elsewhere
    init = max(fsa.initial, 0)

    def remap(s: int) -> int:
        if s == init:
            return 0
        if s == 0:
            return init
        return s

    arcs = []
    for s, out in enumerate(fsa.arcs):
        for a in out:
            arcs.append(
                LatticeArc(
                    remap(s), remap(a.target), a.ilabel - 1, float(a.weight), 0.0
                )
            )
    if lemma_orths is None:
        max_label = max((a.ilabel for out in fsa.arcs for a in out), default=0)
        lemma_orths = [
            fsa.input_symbols.get(i + 1, f"l{i}") for i in range(max_label)
        ]
    n = len(fsa.arcs)
    return Lattice(
        num_nodes=n,
        arcs=arcs,
        node_time=np.full(n, -1, np.int32),
        final_scores={remap(s): float(w) for s, w in fsa.finals.items()},
        lemma_orths=lemma_orths,
    )
