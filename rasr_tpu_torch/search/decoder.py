"""Vectorized frame-synchronous beam search over the prefix tree, in PyTorch.

Counterpart of ``rasr_tpu/search/decoder.py`` on one device: the
within-word and the across-word network (context-conditioned roots,
word ends re-entering at ``we_next``, two final states), unigram LM
lookahead and the history-conditioned bigram / trigram lookahead of
``search/lookahead.py`` (``lookahead_update`` "arc" or "survivor"), the
dense or the compact (``branch_width``) branch fan, an n-gram LM in hash
tables, and the pruning options ``root_arc_limit``, ``root_select``,
``deferred_emission``, ``expansion_limit`` and ``word_end_rank_lm``. A
hypothesis is a dense slot ``(tree_state, lm_state, score, bp)`` (plus
its applied lookahead correction ``phi`` under a bigram lookahead); per
frame, batched over utterances:

1. expansion: self loop, the two dense arcs, the branch fan of the top
   ``branch_hyps`` hypotheses at fan-out states (every overflow arc of
   each, or with ``branch_width`` their arcs packed best hypothesis
   first into that many slots), and the root fan-out of the top
   ``root_hyps`` hypotheses at the root (all G arcs for the best, the
   first ``root_arc_limit`` for the others); with ``root_select`` the
   root fan-out is cut to its R3 best by pre-emission score and kept out
   of steps 3-4. A bigram lookahead adds its class-conditioned
   correction at the root fan-out and, at word-set granularity under
   "arc" updates, the node-crossing delta of every dense and branch arc;
2. the frame's emission score of each candidate's destination state
   (of the top ``expansion_limit`` only; or, with ``deferred_emission``,
   of the K + R3 survivors after step 4);
3. the acoustic beam;
4. exact recombination by (tree_state, lm_state), keeping each key's
   best score, then histogram top-K;
5. word ends over the beam plus the root-select survivors (under
   "survivor" updates their correction is first refreshed to their
   current node's): the correction undone, pre-LM top-R (slot index
   breaks ties; ranked with a static unigram bias under
   ``word_end_rank_lm``), the LM lookup, the word-end beam, traceback
   records and re-entry at the word end's root;
6. top-K over the K + R3 slots plus the R re-entries;
7. utterances past their ``n_frames`` freeze, and each utterance's
   final beam is captured at ``t == n_frames - 1``.

Under first-pass RNN-LM fusion (``search/rnn_fusion.py``) each slot also
carries the row of its RNN state in a pool beside the beam (a
:class:`FusedCarry`): the row rides every candidate column of steps 1-6,
step 5 adds the fused RNN cost of each word-end record to its LM cost and
writes the records' new states to the frame's R pool rows, and the final
selection adds the fused ``</s>`` cost.

The semantics are the reference's, not its TPU layouts: no int32 bit
carriers, no riding state rows or (bp, class) payload packing, no
quarter-row gathers, no sort widths padded to powers of 2; the history
class of a hypothesis is looked up from its LM state (it is a function
of it) where the reference carries it.

Every selection is a STABLE sort, so ties break by lowest index as
``lax.top_k`` does, and a CPU and a CUDA decode of the same scores pick
the same hypotheses. The recombination key is ``state * L + lm`` in
int64; when it fits 31 bits it is packed with the score into one sort
key, otherwise two stable sorts give the same order.

The frame loop is a Python loop over a block of frames from a global
frame ``t0`` (``_decode_block``); ``n_frames`` stays on the device. The
offline decode is one block over the whole utterance, a stream
(``search/streaming.py``) one block per feed, and both end in the same
finalize (``TreeDecoder._finalize``): the offline decode takes the finals
frozen at each utterance's last declared frame (the start hypothesis when
that frame was never decoded), a stream the live beam of utterances whose
end it has not reached. The best path is walked back on the device
(:func:`traceback`); its one host payload is the reference's
``[min(T, 512) + 1, B, 3]`` int32 array.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from ..models.lm.ngram import LookupTables, NgramTables, lookup_prepared, prepare_lookup
from .rnn_fusion import RnnFusionTables, cell_step, word_scores
from .tree import BIG, WORD_NONE, PrefixTree


@dataclasses.dataclass(frozen=True)
class TreeTables:
    """The compiled prefix tree as tensors (+1 sentinel state S)."""

    emission_class: torch.Tensor  # [S+1]
    loop_cost: torch.Tensor  # [S+1]
    # dense 2-slot arcs (chain transitions; SENT/BIG when absent)
    dense1_dst: torch.Tensor  # [S+1]
    dense1_cost: torch.Tensor
    dense1_cls: torch.Tensor
    dense2_dst: torch.Tensor
    dense2_cost: torch.Tensor
    dense2_cls: torch.Tensor
    # branch overflow CSR (arcs beyond the two dense slots)
    branch_ptr: torch.Tensor  # [S+2]
    branch_deg: torch.Tensor  # [S+1]
    branch_dst: torch.Tensor  # [A']
    branch_cost: torch.Tensor
    branch_cls: torch.Tensor
    # root fan-out (static promise order: cost + lookahead)
    root_dst: torch.Tensor  # [G]
    root_cost: torch.Tensor
    root_cls: torch.Tensor
    # word ends
    we_word: torch.Tensor  # [S+1, W]
    we_cost: torch.Tensor
    we_lemma: torch.Tensor
    we_next: torch.Tensor  # [S+1, W] re-entry state (0 = root)
    # LM lookahead potentials (all-zero when disabled) and per-arc deltas
    la: torch.Tensor  # [S+1]
    dense1_dla: torch.Tensor  # [S+1]
    dense2_dla: torch.Tensor  # [S+1]
    branch_dla: torch.Tensor  # [A']
    root_dla: torch.Tensor  # [G]
    num_states: int
    branch_degree: int  # max overflow degree
    root_degree: int
    has_lookahead: bool

    @property
    def sentinel(self) -> int:
        return self.num_states

    def to(self, device) -> "TreeTables":
        return _tensors_to(self, device)


def _tensors_to(tables, device):
    """A copy of a frozen table dataclass with every tensor on ``device``."""
    arrays = {
        f.name: getattr(tables, f.name).to(device)
        for f in dataclasses.fields(tables)
        if isinstance(getattr(tables, f.name), torch.Tensor)
    }
    return dataclasses.replace(tables, **arrays)


@dataclasses.dataclass(frozen=True)
class BigramTables:
    """The bigram-lookahead tables of ``search/lookahead.py`` as tensors.

    ``sub[s]`` in ``[0, num_subtrees]`` is the lookahead node of state s
    (the sentinel ``num_subtrees``, whose ``corr`` column is zero, for the
    roots and the padding state); ``corr`` is unscaled (the decoder
    folds ``lm_scale * lookahead_scale * lookahead_corr_scale`` in).
    Word-set granularity also carries the node-crossing deltas: ``pair1``
    / ``pair2`` (the dense arc slots, per state) and ``pair_br`` (branch
    CSR order) index columns of ``dpair`` (column 0 is zeros: no
    crossing); all None at first-phone granularity, where every
    within-word delta is zero."""

    sub: torch.Tensor  # [S+1] i64
    cls_of_lm: torch.Tensor  # [L] i64
    corr: torch.Tensor  # [C, num_subtrees + 1] f32
    pair1: Optional[torch.Tensor]  # [S+1] i64
    pair2: Optional[torch.Tensor]  # [S+1] i64
    pair_br: Optional[torch.Tensor]  # [A'] i64
    dpair: Optional[torch.Tensor]  # [C, P + 1] f32
    num_subtrees: int
    num_classes: int
    #: general (WFST) networks re-enter at junction states whose node
    #: correction the decoder adds back at each word-end re-entry
    reentry: bool = False

    @property
    def deep(self) -> bool:
        return self.dpair is not None

    def to(self, device) -> "BigramTables":
        return _tensors_to(self, device)


def bigram_to_device(bla, tree: PrefixTree, device=None) -> BigramTables:
    """Host ``BigramLookahead`` -> tables (+ the sentinel state's row; the
    arcs' pair ids split into the decoder's dense and branch slots)."""
    device = resolve(device)
    N = bla.corr.shape[1] - 1
    S = tree.num_states
    sub = np.concatenate([bla.sub_state, [N]]).astype(np.int64)
    if sub.shape[0] != S + 1:
        raise ValueError(f"lookahead of {sub.shape[0] - 1} states for a network of {S}")
    pairs = dict(pair1=None, pair2=None, pair_br=None, dpair=None)
    if bla.deep:
        src, m1, m2, mbr = _arc_slot_split(tree)
        p1 = np.zeros(S + 1, np.int64)
        p2 = np.zeros(S + 1, np.int64)
        p1[src[m1]] = bla.arc_pair[m1]
        p2[src[m2]] = bla.arc_pair[m2]
        br = bla.arc_pair[mbr].astype(np.int64)
        if br.size == 0:
            br = np.zeros(1, np.int64)  # placeholder row (see tree_to_device)
        pairs = dict(pair1=p1, pair2=p2, pair_br=br, dpair=bla.dpair.astype(np.float32))
    return BigramTables(
        sub=torch.as_tensor(sub, device=device),
        cls_of_lm=torch.as_tensor(np.asarray(bla.state_class, np.int64), device=device),
        corr=torch.as_tensor(np.asarray(bla.corr, np.float32), device=device),
        **{k: None if v is None else torch.as_tensor(v, device=device) for k, v in pairs.items()},
        num_subtrees=N,
        num_classes=int(bla.corr.shape[0]),
        reentry=bool(getattr(bla, "reentry", False)),
    )


def _arc_slot_split(tree: PrefixTree):
    """Arc i of state src[i] at within-state position pos: pos 0 -> dense
    slot 1, pos 1 -> dense slot 2, pos >= 2 -> branch CSR (root state 0
    excluded: its arcs are the root fan-out)."""
    S = tree.num_states
    ptr = tree.arc_ptr.astype(np.int64)
    deg = ptr[1:] - ptr[:-1]
    A = int(ptr[-1])
    src = np.repeat(np.arange(S, dtype=np.int64), deg)
    pos = np.arange(A, dtype=np.int64) - ptr[:-1][src]
    nonroot = src >= 1
    return src, nonroot & (pos == 0), nonroot & (pos == 1), nonroot & (pos >= 2)


def _branch_src_of(br_ptr: np.ndarray, S: int, num_arcs: int) -> np.ndarray:
    """Source state of each branch arc (from the CSR ptr)."""
    deg = np.asarray(br_ptr[1 : S + 2]) - np.asarray(br_ptr[: S + 1])
    src = np.repeat(np.arange(S + 1, dtype=np.int64), deg)
    if src.size < num_arcs:  # placeholder row when there are no branch arcs
        src = np.concatenate([src, np.zeros(num_arcs - src.size, np.int64)])
    return src


def tree_to_device(tree: PrefixTree, device=None) -> TreeTables:
    device = resolve(device)
    S = tree.num_states
    SENT = S
    ecls = np.concatenate([tree.emission_class, [0]]).astype(np.int64)
    root_lo, root_hi = int(tree.arc_ptr[0]), int(tree.arc_ptr[1])
    root_dst = tree.arc_dst[root_lo:root_hi].astype(np.int64)
    root_cost = tree.arc_cost[root_lo:root_hi].astype(np.float32)
    if root_dst.size == 0:
        root_dst = np.array([SENT], np.int64)
        root_cost = np.array([BIG], np.float32)

    d1_dst = np.full(S + 1, SENT, np.int64)
    d1_cost = np.full(S + 1, BIG, np.float32)
    d2_dst = np.full(S + 1, SENT, np.int64)
    d2_cost = np.full(S + 1, BIG, np.float32)
    ptr = tree.arc_ptr.astype(np.int64)
    deg = ptr[1:] - ptr[:-1]
    src, m1, m2, mbr = _arc_slot_split(tree)
    d1_dst[src[m1]] = tree.arc_dst[m1]
    d1_cost[src[m1]] = tree.arc_cost[m1]
    d2_dst[src[m2]] = tree.arc_dst[m2]
    d2_cost[src[m2]] = tree.arc_cost[m2]
    br_deg = np.zeros(S + 1, np.int64)
    br_deg[:S] = np.where(np.arange(S) >= 1, np.maximum(deg - 2, 0), 0)
    br_ptr = np.zeros(S + 2, np.int64)
    np.cumsum(br_deg, out=br_ptr[1 : S + 2])
    br_dst_a = tree.arc_dst[mbr].astype(np.int64)
    br_cost_a = tree.arc_cost[mbr].astype(np.float32)
    if br_dst_a.size == 0:
        br_dst_a = np.array([SENT], np.int64)
        br_cost_a = np.array([BIG], np.float32)

    def cls_of(dst):
        return ecls[np.minimum(dst, SENT)]

    la_src = tree.lookahead
    has_la = la_src is not None and bool(np.any(la_src != 0))
    la = np.zeros(S + 1, np.float32)
    if la_src is not None:
        la[:S] = la_src

    # static promise order for the root fan-out (cost + lookahead)
    root_rank = root_cost + (la[np.minimum(root_dst, SENT)] - la[0] if has_la else 0.0)
    root_order = np.argsort(root_rank, kind="stable")
    root_dst = root_dst[root_order]
    root_cost = root_cost[root_order]

    def dla_of(src_idx, dst):
        if not has_la:
            return np.zeros(dst.shape, np.float32)
        return (la[np.minimum(dst, SENT)] - la[src_idx]).astype(np.float32)

    W = tree.max_word_ends
    we_next = tree.we_next if tree.we_next is not None else np.zeros_like(tree.we_word)
    all_states = np.arange(S + 1)
    arrays = dict(
        emission_class=ecls,
        loop_cost=np.concatenate([tree.loop_cost, [BIG]]).astype(np.float32),
        dense1_dst=d1_dst, dense1_cost=d1_cost, dense1_cls=cls_of(d1_dst),
        dense2_dst=d2_dst, dense2_cost=d2_cost, dense2_cls=cls_of(d2_dst),
        branch_ptr=br_ptr, branch_deg=br_deg, branch_dst=br_dst_a,
        branch_cost=br_cost_a, branch_cls=cls_of(br_dst_a),
        root_dst=root_dst, root_cost=root_cost, root_cls=cls_of(root_dst),
        we_word=np.concatenate([tree.we_word, np.full((1, W), WORD_NONE)]).astype(np.int64),
        we_cost=np.concatenate([tree.we_cost, np.full((1, W), BIG)]).astype(np.float32),
        we_lemma=np.concatenate([tree.we_lemma, np.full((1, W), -1)]).astype(np.int64),
        we_next=np.concatenate([we_next, np.zeros((1, W))]).astype(np.int64),
        la=la,
        dense1_dla=dla_of(all_states, d1_dst),
        dense2_dla=dla_of(all_states, d2_dst),
        branch_dla=dla_of(_branch_src_of(br_ptr, S, len(br_dst_a)), br_dst_a),
        root_dla=(
            (la[np.minimum(root_dst, SENT)] - la[0]).astype(np.float32)
            if has_la else np.zeros(root_dst.shape[0], np.float32)
        ),
    )
    return TreeTables(
        **{k: torch.as_tensor(v, device=device) for k, v in arrays.items()},
        num_states=S,
        branch_degree=max(int(br_deg.max()), 1),
        root_degree=int(root_dst.shape[0]),
        has_lookahead=has_la,
    )


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Pruning parameters (same fields as the reference's BeamConfig).

    ``scan_unroll`` has no meaning here (PyTorch runs the frame loop
    eagerly) and ``force_unpacked_keys`` selects the two-sort
    recombination, whose results are identical."""

    max_hyps: int = 1024  # histogram pruning cap (K)
    beam: float = 1e9  # acoustic beam width
    word_end_limit: int = 128  # R: word-end survivors / records per frame
    #: relative beam over the R word-end records after the exact LM cost
    word_end_beam: float = 1e9
    #: rank word-end candidates by path score + the word's static unigram
    #: cost (selection only: the bias is undone on the R survivors)
    word_end_rank_lm: bool = False
    root_hyps: int = 32  # H: root (re-entry) hyps expanded per frame
    branch_hyps: int = 0  # Kb: hyps expanded through branch arcs (0 = K)
    #: Wb: compact branch expansion, the Kb hyps' overflow arcs packed
    #: contiguously (best hyp first) into Wb slots per utterance instead
    #: of the padded [Kb, max degree] fan; overflow drops the worst
    #: selected hyps' arcs, Wb >= Kb * max degree is the dense fan's
    #: candidate set (0 = the dense fan)
    branch_width: int = 0
    #: E: keep the E best candidates by pre-emission score before the
    #: emission gather (0 = off; ignored under ``deferred_emission``)
    expansion_limit: int = 0
    #: non-best root hypotheses expand only the first root_arc_limit root
    #: arcs in static promise order (0 = all)
    root_arc_limit: int = 0
    #: R3: pre-emission top-R3 over the root fan-out, kept out of the main
    #: recombination; the survivors join the word-end scan and the merge
    root_select: int = 0
    #: add the frame's emission after recombination + top-K, to the K + R3
    #: survivors only (the beam cuts rank pre-emission scores)
    deferred_emission: bool = False
    lm_scale: float = 1.0
    #: weight of the unigram lookahead potential (x lm_scale); exact
    #: potential shaping: path scores unchanged, pruning LM-aware
    lookahead_scale: float = 1.0
    #: extra weight on the bigram / trigram correction level only
    lookahead_corr_scale: float = 1.0
    #: word-set lookahead correction updates: "arc" (exact: every dense
    #: and branch candidate adds its node-crossing delta) or "survivor"
    #: (the reference's lazy activation: candidates keep their source
    #: node's correction, refreshed once per frame for the K + R3
    #: survivors; not exact)
    lookahead_update: str = "arc"
    scan_unroll: int = 1
    force_unpacked_keys: bool = False


def _stable_order(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries per row, ties by lowest index
    (``lax.top_k``'s order)."""
    return torch.sort(x, dim=1, stable=True).indices[:, :k]


def _orderable(score: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 in [0, 2^32) with the same order as the floats."""
    i = score.view(torch.int32).to(torch.int64)
    return torch.where(i >= 0, i, -(i & 0x7FFFFFFF) - 1) + (1 << 31)


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Row-wise index of the FIRST minimum (device-independent ties)."""
    n = x.shape[1]
    iota = torch.arange(n, device=x.device).expand_as(x)
    hit = x == x.min(dim=1, keepdim=True).values
    return torch.where(hit, iota, n).min(dim=1).values


class Carry(NamedTuple):
    """Beam state between frames, plus the captured finals."""

    state: torch.Tensor  # [B, K] i64
    lms: torch.Tensor  # [B, K] i64
    score: torch.Tensor  # [B, K] f32
    bp: torch.Tensor  # [B, K] i64 (record id of the last word end, -1)
    fstate: torch.Tensor
    flm: torch.Tensor
    fscore: torch.Tensor
    fbp: torch.Tensor
    #: [B, K] f32 lookahead correction applied to each slot's score (the
    #: word ends undo it; zeros without a bigram lookahead)
    phi: torch.Tensor


class FusedCarry(NamedTuple):
    """:class:`Carry` under RNN-LM fusion (``search/rnn_fusion.py``), plus
    each slot's and each final's row of the hidden-state pools ``cs`` /
    ``hs`` ``[B, P + 1, H]``."""

    state: torch.Tensor
    lms: torch.Tensor
    score: torch.Tensor
    bp: torch.Tensor
    fstate: torch.Tensor
    flm: torch.Tensor
    fscore: torch.Tensor
    fbp: torch.Tensor
    phi: torch.Tensor
    rnn_row: torch.Tensor  # [B, K] i64
    f_rnnrow: torch.Tensor
    cs: torch.Tensor  # [B, P + 1, H] f32
    hs: torch.Tensor


class Records(NamedTuple):
    """Per-frame word-end records ``[T, B, R]`` (the traceback store). The
    integer columns are int32, as the reference's: record ids ``t * R + r``,
    lemma, word and LM state ids all stay below 2^31."""

    lemma: torch.Tensor  # i32, -1 = none
    score: torch.Tensor  # f32
    prev: torch.Tensor  # i32 predecessor record id, -1 = start
    lmcost: torch.Tensor  # f32
    word: torch.Tensor  # i32
    lm: torch.Tensor  # i32 LM state after the word


def init_carry(B: int, cfg: BeamConfig, lm: NgramTables, device, rnn=None,
               rnn_pool: int = 0):
    """One live hypothesis per utterance at the tree root in the LM start
    state; every other slot BIG. With RNN fusion (``rnn``) the pools hold
    ``rnn_pool`` writable rows and the state after ``<s>`` at row
    ``rnn_pool``, where every slot starts (a :class:`FusedCarry`)."""
    K = cfg.max_hyps
    state0 = torch.zeros((B, K), dtype=torch.int64, device=device)
    lm0 = torch.full((B, K), lm.start_state, dtype=torch.int64, device=device)
    score0 = torch.full((B, K), BIG, dtype=torch.float32, device=device)
    score0[:, 0] = 0.0
    bp0 = torch.full((B, K), -1, dtype=torch.int64, device=device)
    phi0 = torch.zeros((B, K), dtype=torch.float32, device=device)  # phi(root) = 0
    c = Carry(state0, lm0, score0, bp0, state0, lm0, score0, bp0, phi0)
    if rnn is None:
        return c
    H = rnn.hidden
    cs = torch.zeros((B, rnn_pool + 1, H), dtype=torch.float32, device=device)
    hs = torch.zeros((B, rnn_pool + 1, H), dtype=torch.float32, device=device)
    cs[:, rnn_pool] = rnn.init_c
    hs[:, rnn_pool] = rnn.init_h
    row0 = torch.full((B, K), rnn_pool, dtype=torch.int64, device=device)
    return FusedCarry(*c, row0, row0, cs, hs)


def _compact_rnn_carry(c: FusedCarry, tb_rows: int) -> FusedCarry:
    """A stream's pool compaction between feeds: the only rows a later
    frame can read are those of the live beam (``rnn_row``) and of the
    frozen finals (``f_rnnrow``), at most 2K per utterance. They move to
    rows ``[0, 2K)`` and the pool is sized for the next block's ``tb_rows``
    writes: 2K + R x Tb rows whatever the stream's length."""
    B, K = c.rnn_row.shape
    bidx = torch.arange(B, device=c.rnn_row.device)[:, None]

    def compact(pool):
        new = torch.zeros((B, 2 * K + tb_rows, pool.shape[2]), dtype=pool.dtype,
                          device=pool.device)
        new[:, :K] = pool[bidx, c.rnn_row]
        new[:, K: 2 * K] = pool[bidx, c.f_rnnrow]
        return new

    row = torch.arange(K, device=c.rnn_row.device).expand(B, K)
    return c._replace(rnn_row=row, f_rnnrow=row + K, cs=compact(c.cs), hs=compact(c.hs))


class _Step:
    """The per-frame step over one decoder's tables (built once per
    decode: the shaped cost columns are loop-invariant)."""

    def __init__(self, tree: TreeTables, lm: NgramTables, prep: LookupTables,
                 cfg: BeamConfig, wmax: int, hroot: int, kbranch: int,
                 bla: Optional[BigramTables] = None, rnn=None):
        self.tree, self.lm, self.prep, self.cfg = tree, lm, prep, cfg
        self.rnn = rnn
        self.wmax, self.hroot, self.kbranch = wmax, hroot, kbranch
        use_la = tree.has_lookahead and cfg.lookahead_scale != 0.0
        la_coeff = cfg.lm_scale * cfg.lookahead_scale

        def shaped(cost, dla):
            return cost + la_coeff * dla if use_la else cost

        self.d1_cost = shaped(tree.dense1_cost, tree.dense1_dla)
        self.d2_cost = shaped(tree.dense2_cost, tree.dense2_dla)
        self.br_cost = shaped(tree.branch_cost, tree.branch_dla)
        self.root_cost = shaped(tree.root_cost, tree.root_dla)
        G = tree.root_degree
        self.gcap = min(cfg.root_arc_limit or G, G)
        root_width = G + max(hroot - 1, 0) * self.gcap  # Wr
        self.rsel = min(cfg.root_select, root_width) if cfg.root_select > 0 else 0  # R3
        self.compact = cfg.branch_width > 0
        Wbr = cfg.branch_width if self.compact else kbranch * tree.branch_degree
        cand_width = 3 * cfg.max_hyps + Wbr + (0 if self.rsel else root_width)
        E = cfg.expansion_limit
        self.elimit = E if 0 < E < cand_width and not cfg.deferred_emission else 0

        # bigram lookahead: the class-conditioned correction, scaled once;
        # the root fan-out's per-(class, arc) corrections pre-selected in
        # the fan's static promise order
        corr_coeff = la_coeff * cfg.lookahead_corr_scale
        self.bla = bla if bla is not None and corr_coeff != 0.0 else None
        self.lazy = self.bla is not None and bla.deep and cfg.lookahead_update == "survivor"
        self.deep_arc = self.bla is not None and bla.deep and not self.lazy
        if self.bla is not None:
            self.corr = corr_coeff * bla.corr  # [C, N+1]
            self.corr_arc = self.corr[:, bla.sub[tree.root_dst]]  # [C, G]
        if self.deep_arc:
            self.dpair = corr_coeff * bla.dpair  # [C, P+1]

        # word-end columns [S+1, W]. The unigram-potential undo at word
        # ends is a per-state constant -la_coeff * (la[s] - la[root]),
        # folded into the word-end costs.
        we_cost = tree.we_cost
        if use_la:
            we_cost = tree.we_cost - la_coeff * (tree.la - tree.la[0])[:, None]
        we = dict(word=tree.we_word, cost=we_cost, lemma=tree.we_lemma, next=tree.we_next)
        self.rank_lm = cfg.word_end_rank_lm
        if self.rank_lm:
            # static unigram estimate per slot (the prepared dense final
            # LM level); with W > 1 the slots are re-sorted by the biased
            # rank so that slot 0 still bounds its state's slots
            V = prep.uni_cost.shape[0] - 1
            uni = prep.uni_cost[torch.clamp(tree.we_word, 0, V)]
            we["bias"] = torch.where(tree.we_word >= 0, cfg.lm_scale * uni, 0.0)
            if wmax > 1:
                order = torch.sort(tree.we_cost + we["bias"], dim=1, stable=True).indices
                we = {k: v.gather(1, order) for k, v in we.items()}
        self.we = we
        self.br_ptr = tree.branch_ptr[:-1]
        self.slots = torch.arange(
            cfg.branch_width if self.compact else tree.branch_degree, device=tree.la.device
        )
        self.L = lm.num_states
        self.pack_keys = (
            (tree.sentinel + 1) * self.L < 2**31 and not cfg.force_unpacked_keys
        )

    def _recombine_topk(self, key, score, k):
        """Dedup by key keeping each key's min score, then the k best.
        Returns the row indices (into the candidate width) of the k
        survivors and their deduped scores."""
        if self.pack_keys:
            order = torch.sort((key << 32) | _orderable(score), dim=1, stable=True).indices
        else:
            order = torch.sort(score, dim=1, stable=True).indices
            order = order.gather(1, torch.sort(key.gather(1, order), dim=1, stable=True).indices)
        skey = key.gather(1, order)
        first = torch.ones_like(skey, dtype=torch.bool)
        first[:, 1:] = skey[:, 1:] != skey[:, :-1]
        dscore = torch.where(first, score.gather(1, order), BIG)
        top = _stable_order(dscore, k)
        return order.gather(1, top), dscore.gather(1, top)

    def _branch_fan(self, state, score, hyp_cols, cls):
        """The branch fan of the top-Kb hyps at fan-out states: per
        hypothesis every overflow arc (the dense ``[Kb, Db]`` fan,
        flattened), or with ``branch_width`` the arcs packed contiguously
        best hypothesis first into the slot budget (exclusive cumsum of
        the live hyps' degrees; pruned hyps take no slots, unused slots
        are the sentinel at BIG). Returns the ``[B, W]`` destination
        states, their emission classes, pre-emission scores, the
        correction deltas (None unless arc-exact word-set lookahead) and
        each ``hyp_cols`` column per slot."""
        tree, Kb = self.tree, self.kbranch
        B = state.shape[0]
        br_sel = torch.where(tree.branch_deg[state] > 0, score, BIG)
        bidx = _stable_order(br_sel, Kb)
        b_score = br_sel.gather(1, bidx)
        b_state = state.gather(1, bidx)
        b_deg, b_ptr = tree.branch_deg[b_state], self.br_ptr[b_state]
        if self.compact:
            deg = torch.where(b_score < BIG / 2, b_deg, 0)
            off = torch.cumsum(deg, dim=1) - deg  # [B, Kb], non-decreasing
            slots = self.slots.expand(B, -1).contiguous()
            hh = torch.clamp(torch.searchsorted(off, slots, right=True) - 1, 0, Kb - 1)
            pos = slots - off.gather(1, hh)
            ok = (pos >= 0) & (pos < deg.gather(1, hh))
            arc = torch.where(ok, b_ptr.gather(1, hh) + pos, 0)

            def per_slot(x):  # [B, Kb] -> [B, Wb]
                return x.gather(1, hh)
        else:
            Db = tree.branch_degree
            ok = (self.slots < b_deg[..., None]).reshape(B, -1)
            arc = torch.where(ok, (b_ptr[..., None] + self.slots).reshape(B, -1), 0)

            def per_slot(x):  # [B, Kb] -> [B, Kb * Db]
                return x.repeat_interleave(Db, dim=1)
        cost = torch.where(ok, self.br_cost[arc], BIG)
        dphi = None
        if self.deep_arc:
            dphi = self.dpair[per_slot(cls.gather(1, bidx)),
                              torch.where(ok, self.bla.pair_br[arc], 0)]
            cost = cost + dphi
        p_br = per_slot(b_score) + cost
        br_state = torch.where(ok, tree.branch_dst[arc], tree.sentinel)
        br_cls = torch.where(ok, tree.branch_cls[arc], 0)
        return br_state, br_cls, p_br, dphi, [per_slot(x.gather(1, bidx)) for x in hyp_cols]

    def _root_fanout(self, state, lms, score, bp, cls, rnn_row=None):
        """Root re-entry: the best root hypothesis expands all G root arcs,
        the next H-1 only the first gcap (static promise order). Returns
        the ``[B, Wr]`` pre-emission scores (with the lookahead correction
        of the hypothesis' class), destination states, their emission
        classes, the source LM states, backpointers and RNN pool rows (None
        without fusion), and the applied corrections (None without a
        bigram lookahead)."""
        tree, H, gcap = self.tree, self.hroot, self.gcap
        B, G = state.shape[0], tree.root_degree
        root_sel = torch.where(state == 0, score, BIG)
        hidx = _stable_order(root_sel, H)
        h_score = root_sel.gather(1, hidx)  # ascending: h=0 is the best
        h_lm, h_bp = lms.gather(1, hidx), bp.gather(1, hidx)
        p_root = torch.cat([
            h_score[:, :1] + self.root_cost,
            (h_score[:, 1:, None] + self.root_cost[:gcap]).reshape(B, (H - 1) * gcap),
        ], dim=1)
        root_phi = None
        if self.bla is not None:
            h_cls = cls.gather(1, hidx)
            root_phi = torch.cat([
                self.corr_arc[h_cls[:, 0]],
                self.corr_arc[:, :gcap][h_cls[:, 1:]].reshape(B, (H - 1) * gcap),
            ], dim=1)
            p_root = p_root + root_phi

        def fan(per_arc):  # [G] -> [B, Wr]
            return torch.cat([per_arc, per_arc[:gcap].repeat(H - 1)]).expand(B, -1)

        def per_hyp(h):  # [B, H] -> [B, Wr]
            return torch.cat([h[:, :1].expand(B, G), h[:, 1:].repeat_interleave(gcap, dim=1)],
                             dim=1)

        h_rnn = None if rnn_row is None else per_hyp(rnn_row.gather(1, hidx))
        return (p_root, fan(tree.root_dst), fan(tree.root_cls), per_hyp(h_lm), per_hyp(h_bp),
                h_rnn, root_phi)

    def __call__(self, c, emis_t: torch.Tensor, t: int,
                 n_frames: torch.Tensor, recs: Records, row: int, pool_row: int = 0):
        """Frame ``t`` (global: record ids ``t * R + r``); its word-end
        records go to row ``row`` of ``recs`` and, under RNN fusion, their
        states to pool rows ``pool_row + r``."""
        tree, cfg, bla, rnn = self.tree, self.cfg, self.bla, self.rnn
        SENT = tree.sentinel
        K, R, L = cfg.max_hyps, cfg.word_end_limit, self.L
        B = c.state.shape[0]
        active = (t < n_frames)[:, None]
        state, lms, score, bp, phi = c.state, c.lms, c.score, c.bp, c.phi
        cls = bla.cls_of_lm[lms] if bla is not None else None  # history class

        def emis(cls):
            return emis_t.gather(1, cls)

        # ---- expansion: loop, dense arcs (pre-emission path scores and
        # the destination's emission class per candidate)
        p_loop = score + tree.loop_cost[state]
        d1 = tree.dense1_dst[state]
        p_d1 = score + self.d1_cost[state]
        d2 = tree.dense2_dst[state]
        p_d2 = score + self.d2_cost[state]
        phi_d1 = phi_d2 = phi
        if self.deep_arc:
            # word-set lookahead: each dense arc's node-crossing delta
            dd1 = self.dpair[cls, bla.pair1[state]]
            dd2 = self.dpair[cls, bla.pair2[state]]
            p_d1, p_d2 = p_d1 + dd1, p_d2 + dd2
            phi_d1, phi_d2 = phi + dd1, phi + dd2

        # ---- branch fan: top-Kb hyps at fan-out states (the RNN pool row
        # rides as the last payload column)
        rnn_row = c.rnn_row if rnn is not None else None
        br_state, br_cls, p_br, br_dphi, br_hyp = self._branch_fan(
            state, score, [lms, bp] + ([phi] if bla is not None else [])
            + ([rnn_row] if rnn is not None else []), cls)
        br_lm, br_bp = br_hyp[:2]

        p_root, root_state, root_cls, root_lm, root_bp, root_rnn, root_phi = self._root_fanout(
            state, lms, score, bp, cls, rnn_row)
        sections = [[state, lms, bp, p_loop, tree.emission_class[state]],
                    [d1, lms, bp, p_d1, tree.dense1_cls[state]],
                    [d2, lms, bp, p_d2, tree.dense2_cls[state]],
                    [br_state, br_lm, br_bp, p_br, br_cls]]
        if bla is not None:
            # each candidate's applied correction rides beside it
            br_phi = br_hyp[2] if br_dphi is None else br_hyp[2] + br_dphi
            for sec, x in zip(sections, (phi, phi_d1, phi_d2, br_phi)):
                sec.append(x)
        if rnn is not None:
            for sec, x in zip(sections, (rnn_row, rnn_row, rnn_row, br_hyp[-1])):
                sec.append(x)
        if self.rsel:
            # root select: pre-emission top-R3 over the root fan-out; the
            # survivors skip the recombination and join the word ends
            rs_idx = _stable_order(p_root, self.rsel)
            rs_pre = torch.clamp(p_root.gather(1, rs_idx), max=BIG)
            rs_state = root_state.gather(1, rs_idx)
            rs_lm, rs_bp = root_lm.gather(1, rs_idx), root_bp.gather(1, rs_idx)
            rs_rnn = root_rnn.gather(1, rs_idx) if rnn is not None else None
            if cfg.deferred_emission:
                rs_score = rs_pre
            else:
                rs_score = torch.where(
                    rs_pre < BIG / 2, rs_pre + emis(root_cls.gather(1, rs_idx)), BIG
                )
        else:
            sections.append([root_state, root_lm, root_bp, p_root, root_cls]
                            + ([root_phi] if bla is not None else [])
                            + ([root_rnn] if rnn is not None else []))
        # cand_x: the applied correction (bigram lookahead), then the RNN row
        cand_state, cand_lm, cand_bp, cand_pre, cand_cls, *cand_x = (
            torch.cat(cols, dim=1) for cols in zip(*sections)
        )
        cand_pre = torch.clamp(cand_pre, max=BIG)
        if cfg.deferred_emission:
            # the survivors' emission is added at the word ends (it is a
            # function of the destination state, part of the key)
            cand_score = cand_pre
        elif self.elimit:
            # expansion limit: top-E by pre-emission score, then the
            # emission for the E survivors only
            eidx = _stable_order(cand_pre, self.elimit)
            cand_state, cand_lm, cand_bp, cand_pre, cand_cls, *cand_x = (
                x.gather(1, eidx) for x in (cand_state, cand_lm, cand_bp, cand_pre, cand_cls,
                                            *cand_x)
            )
            cand_score = torch.where(cand_pre < BIG / 2, cand_pre + emis(cand_cls), BIG)
        else:
            cand_score = torch.clamp(cand_pre + emis(cand_cls), max=BIG)

        # ---- acoustic beam (over the root-select survivors too)
        best = cand_score.min(dim=1, keepdim=True).values
        if self.rsel:
            best = torch.minimum(best, rs_score.min(dim=1, keepdim=True).values)
            rs_score = torch.where(rs_score > best + cfg.beam, BIG, rs_score)
        cand_score = torch.where(cand_score > best + cfg.beam, BIG, cand_score)

        # ---- recombination + histogram top-K (the winner keeps its
        # applied correction)
        sel, n_score = self._recombine_topk(
            cand_state * L + cand_lm, cand_score, min(K, cand_score.shape[1])
        )
        n_state = torch.where(n_score >= BIG / 2, SENT, cand_state.gather(1, sel))
        n_lm = cand_lm.gather(1, sel)
        n_bp = cand_bp.gather(1, sel)
        n_phi = cand_x[0].gather(1, sel) if bla is not None else None
        # the winner of each key keeps its own RNN row: truncated-history
        # recombination (rnn_fusion.py)
        n_rnn = cand_x[-1].gather(1, sel) if rnn is not None else None

        # ---- word ends scan the beam plus the root-select survivors
        if self.rsel:
            rs_state = torch.where(rs_score >= BIG / 2, SENT, rs_state)
            w_state = torch.cat([n_state, rs_state], dim=1)
            w_lm = torch.cat([n_lm, rs_lm], dim=1)
            w_score = torch.cat([n_score, rs_score], dim=1)
            w_bp = torch.cat([n_bp, rs_bp], dim=1)
            if bla is not None:
                n_phi = torch.cat([n_phi, root_phi.gather(1, rs_idx)], dim=1)
            w_rnn = torch.cat([n_rnn, rs_rnn], dim=1) if rnn is not None else None
        else:
            w_state, w_lm, w_score, w_bp, w_rnn = n_state, n_lm, n_score, n_bp, n_rnn
        w_phi = n_phi
        if self.lazy:
            # survivor update: each survivor takes its current node's
            # correction, its score moving by (fresh - applied)
            fresh = self.corr[bla.cls_of_lm[w_lm], bla.sub[w_state]]
            w_score = torch.where(w_score < BIG / 2, w_score + (fresh - w_phi), w_score)
            w_phi = fresh
        if cfg.deferred_emission:
            w_score = torch.where(
                w_score < BIG / 2, w_score + emis(tree.emission_class[w_state]), BIG
            )
        # the word ends see the score without the bigram correction (the
        # unigram potential's undo is folded into the word-end costs)
        we_base = w_score - w_phi if bla is not None else w_score

        # ---- pre-LM top-R (ties by slot index)
        W, we = self.wmax, self.we
        if W == 1:
            cost0 = we["cost"][:, 0] + we["bias"][:, 0] if self.rank_lm else we["cost"][:, 0]
            pre = torch.where(we["word"][w_state, 0] != WORD_NONE,
                              we_base + cost0[w_state], BIG)
            ridx = _stable_order(pre, R)
            r_pre = pre.gather(1, ridx)
            r_src = w_state.gather(1, ridx)
            r_slot = torch.zeros_like(r_src)
            r_src_w = ridx
        else:
            # two-stage exact top-R: word-end slots are sorted per state
            # by the selection rank, so slot 0 bounds its state's slots
            def ranked(base, *idx):
                pre = base + we["cost"][idx]
                return pre + we["bias"][idx] if self.rank_lm else pre

            pre0 = torch.where(we["word"][w_state, 0] != WORD_NONE,
                               ranked(we_base, w_state, 0), BIG)
            Rh = min(R, pre0.shape[1])
            hsel = _stable_order(pre0, Rh)
            s_r = w_state.gather(1, hsel)
            pre = torch.where(
                we["word"][s_r] != WORD_NONE,
                ranked(we_base.gather(1, hsel)[..., None], s_r), BIG,
            ).reshape(B, Rh * W)
            ridx = _stable_order(pre, R)
            r_pre = pre.gather(1, ridx)
            hr = torch.div(ridx, W, rounding_mode="floor")
            r_slot = ridx % W
            r_src = s_r.gather(1, hr)
            r_src_w = hsel.gather(1, hr)
        r_srclm = w_lm.gather(1, r_src_w)
        r_srcbp = w_bp.gather(1, r_src_w)
        r_word = we["word"][r_src, r_slot]
        r_lemma = we["lemma"][r_src, r_slot]
        r_next = we["next"][r_src, r_slot]
        if self.rank_lm:
            # undo the selection bias: the exact LM cost replaces it
            r_pre = torch.where(r_pre < BIG / 2, r_pre - we["bias"][r_src, r_slot], r_pre)

        is_lm_word = r_word >= 0
        lm_cost, lm_next = lookup_prepared(
            self.lm, self.prep, r_srclm, torch.clamp(r_word, min=0)
        )
        r_lmcost = torch.where(is_lm_word, cfg.lm_scale * lm_cost, 0.0)
        r_newlm = torch.where(is_lm_word, lm_next, r_srclm)
        if rnn is not None:
            r_lmcost, new_rnn = self._rnn_word_ends(c, w_rnn.gather(1, r_src_w), r_word,
                                                    is_lm_word, r_lmcost, active, pool_row)
        r_score = torch.where(r_pre < BIG / 2, r_pre + r_lmcost, BIG)
        if cfg.word_end_beam < 1e8:
            we_best = r_score.min(dim=1, keepdim=True).values
            r_score = torch.where(r_score > we_best + cfg.word_end_beam, BIG, r_score)
        r_valid = (r_score < BIG / 2) & active

        rec_id = t * R + torch.arange(R, device=r_score.device).expand(B, R)
        re_state = torch.where(r_valid, r_next, SENT)
        re_score = torch.where(r_valid, r_score, BIG)
        re_phi = None
        if bla is not None and bla.reentry:
            # general (WFST) networks re-enter at junction states whose
            # lookahead node is no zero-sentinel root: the re-entering
            # score takes the node's correction under its new history,
            # and carries it for the next word end's undo
            re_phi = torch.where(r_valid, self.corr[bla.cls_of_lm[r_newlm], bla.sub[re_state]], 0.0)
            re_score = torch.where(r_valid, re_score + re_phi, BIG)

        # ---- merge the word-end re-entries (and root-select survivors);
        # a re-entry at a root carries the root's correction, 0
        m_score = torch.cat([w_score, re_score], dim=1)
        midx = _stable_order(m_score, K)
        f_score = m_score.gather(1, midx)
        f_state = torch.where(
            f_score >= BIG / 2, SENT, torch.cat([w_state, re_state], dim=1).gather(1, midx)
        )
        f_lm = torch.cat([w_lm, r_newlm], dim=1).gather(1, midx)
        f_bp = torch.cat([w_bp, rec_id], dim=1).gather(1, midx)
        if rnn is not None:
            f_rnn = torch.cat([w_rnn, new_rnn], dim=1).gather(1, midx)
            rnn_row = torch.where(active, f_rnn, rnn_row)

        # ---- freeze finished utterances, capture finals at their last frame
        state = torch.where(active, f_state, state)
        lms = torch.where(active, f_lm, lms)
        score = torch.where(active, f_score, score)
        bp = torch.where(active, f_bp, bp)
        if bla is not None:
            if re_phi is None:
                re_phi = torch.zeros_like(re_score)
            f_phi = torch.cat([w_phi, re_phi], dim=1).gather(1, midx)
            phi = torch.where(active, f_phi, phi)
        is_last = (t == n_frames - 1)[:, None]

        recs.lemma[row] = torch.where(r_valid, r_lemma, -1)
        recs.score[row] = torch.where(r_valid, r_score, BIG)
        recs.prev[row] = torch.where(r_valid, r_srcbp, -1)
        recs.lmcost[row] = r_lmcost
        recs.word[row] = torch.where(r_valid, r_word, WORD_NONE)
        recs.lm[row] = torch.where(r_valid, r_newlm, -1)
        core = (
            state, lms, score, bp,
            torch.where(is_last, state, c.fstate),
            torch.where(is_last, lms, c.flm),
            torch.where(is_last, score, c.fscore),
            torch.where(is_last, bp, c.fbp),
            phi,
        )
        if rnn is None:
            return Carry(*core)
        return FusedCarry(*core, rnn_row, torch.where(is_last, rnn_row, c.f_rnnrow), c.cs, c.hs)

    def _rnn_word_ends(self, c: FusedCarry, r_srcrow, r_word, is_lm_word, r_lmcost, active,
                       pool_row: int):
        """The fused RNN-LM score and state update of the R word-end records
        ``[B, R]``: each record's source state from its carried pool row, one
        cell step and one projection; the cost ``weight * -log p`` (or
        ``weight * oov_cost`` for an n-gram word the RNN LM lacks, 0 for
        silence) joins the LM cost. The new states fill pool rows
        ``pool_row + r`` in place (silence and unknown words pass their
        source state on; frozen utterances keep the rows' contents).
        Returns the LM cost and the re-entries' rows."""
        rnn = self.rnn
        B, R = r_word.shape
        bidx = torch.arange(B, device=r_word.device)[:, None]
        h_src = c.hs[bidx, r_srcrow]  # [B, R, H]
        c_src = c.cs[bidx, r_srcrow]
        wid = rnn.word_map[torch.clamp(r_word, min=0)]
        scored = is_lm_word & (wid >= 0)
        wid = torch.clamp(wid, min=0)
        rnn_cost = torch.where(
            scored, rnn.weight * word_scores(rnn, h_src, wid),
            torch.where(is_lm_word, rnn.weight * rnn.oov_cost, 0.0))
        c_new, h_new = cell_step(rnn, rnn.emb[wid], c_src, h_src)
        adv = (scored & active)[..., None]
        keep = active[..., None]
        rows = slice(pool_row, pool_row + R)
        c.cs[:, rows] = torch.where(keep, torch.where(adv, c_new, c_src), c.cs[:, rows])
        c.hs[:, rows] = torch.where(keep, torch.where(adv, h_new, h_src), c.hs[:, rows])
        new_row = (pool_row + torch.arange(R, device=r_word.device)).expand(B, R)
        return r_lmcost + rnn_cost, new_row


class HostRecords(NamedTuple):
    """A decode's traceback records and final beams on the host, as the
    lattice builder reads them (``lattice.lattice_from_records``)."""

    records: tuple  # (lemma, score, prev, lmcost, word, lm) [T, B, R]
    finals: tuple  # (state, lm, score, bp, end_cost) [B, K]
    n_frames: np.ndarray  # [B]


@dataclasses.dataclass(eq=False)
class DeviceDecode:
    """Handle of one dispatched decode: the best hypothesis per utterance,
    the records its traceback walks and the final beams with their
    ``</s>`` costs (the lattice's inputs). Each handle owns its records."""

    best_score: torch.Tensor  # [B] f32
    best_bp: torch.Tensor  # [B] i64
    records: Records
    finals: Carry
    end_cost: torch.Tensor  # [B, K] scaled </s> cost of the finals
    word_end_limit: int
    n_frames: torch.Tensor  # [B] declared frames
    num_final_states: int
    _host: Optional[HostRecords] = dataclasses.field(default=None, repr=False)

    def records_to_host(self) -> HostRecords:
        """The six record columns, the final beams and ``n_frames`` copied
        to the host, once per handle (the lattice path; the best path
        needs only :func:`traceback`'s payload)."""
        if self._host is None:
            f = self.finals
            self._host = HostRecords(
                tuple(r.cpu().numpy() for r in self.records),
                tuple(x.cpu().numpy() for x in (f.fstate, f.flm, f.fscore, f.fbp,
                                                 self.end_cost)),
                self.n_frames.cpu().numpy(),
            )
        return self._host


def _decode_block(step: _Step, c: Carry, emissions: torch.Tensor, t0: int,
                  n_frames: torch.Tensor, rnn_base: int = 0):
    """Advance the beam over one block of frames ``[B, Tb, M]`` whose first
    frame is the utterances' frame ``t0`` (the counterpart of the
    reference's ``_decode_block``): returns the carry and the block's
    records ``[Tb, B, R]``. The offline decode is one block from frame 0;
    a stream is one block per feed. Under RNN fusion the block's frame i
    writes pool rows ``rnn_base + i * R + r``."""
    B, Tb, _ = emissions.shape
    R, dev = step.cfg.word_end_limit, emissions.device

    def rec(dtype, fill):
        return torch.full((Tb, B, R), fill, dtype=dtype, device=dev)

    recs = Records(rec(torch.int32, -1), rec(torch.float32, BIG), rec(torch.int32, -1),
                   rec(torch.float32, 0.0), rec(torch.int32, WORD_NONE), rec(torch.int32, -1))
    for i in range(Tb):
        c = step(c, emissions[:, i], t0 + i, n_frames, recs, i, rnn_base + i * R)
    return c, recs


def _best(lm, prep, c: Carry, cfg: BeamConfig, nfinal: int,
          rnn: Optional[RnnFusionTables] = None):
    """Final best-hypothesis selection (the ``</s>`` cost applied to
    complete hypotheses at a final state, with the fused RNN LM's from
    each final's pool row; the best incomplete one when there is none):
    ``(best_score, best_bp, end_cost)``."""
    end_cost, _ = lookup_prepared(
        lm, prep, c.flm, torch.full_like(c.flm, max(lm.end_word, 0))
    )
    end_cost = cfg.lm_scale * end_cost if lm.end_word >= 0 else torch.zeros_like(end_cost)
    if rnn is not None and rnn.end_wid >= 0:
        bidx = torch.arange(c.hs.shape[0], device=c.hs.device)[:, None]
        end_cost = end_cost + rnn.weight * word_scores(
            rnn, c.hs[bidx, c.f_rnnrow], torch.full_like(c.f_rnnrow, rnn.end_wid))
    final_total = torch.where(c.fstate < nfinal, c.fscore + end_cost, BIG)
    best_idx = _first_argmin(final_total)[:, None]
    best_score = final_total.gather(1, best_idx)[:, 0]
    best_bp = c.fbp.gather(1, best_idx)[:, 0]
    fb_idx = _first_argmin(c.fscore)[:, None]
    incomplete = best_score >= BIG / 2
    best_score = torch.where(incomplete, c.fscore.gather(1, fb_idx)[:, 0], best_score)
    best_bp = torch.where(incomplete, c.fbp.gather(1, fb_idx)[:, 0], best_bp)
    return best_score, best_bp, end_cost


#: the walk's length cap (the reference's ``min(T, 512)`` scan)
MAX_WALK = 512
#: walk steps dispatched between two reads of "every chain has ended"
WALK_CHUNK = 32


def traceback(handle: DeviceDecode) -> torch.Tensor:
    """The best paths walked back on the device: the reference's one host
    payload, ``[min(T, 512) + 1, B, 3]`` int32. Row i holds each
    utterance's i-th word end from the end, ``(lemma, frame, record id)``,
    -1 past the chain's start; the last row is the best score's float32
    bits. The walk gathers each step's predecessor from the ``prev``
    column laid out per utterance, and stops after the chunk of steps in
    which every chain reached its start (one device read per chunk)."""
    recs = handle.records
    T, B, R = recs.lemma.shape
    n = T * R  # record ids are t * R + r; n is "no record"
    dev = recs.lemma.device

    def per_utt(col):  # [T, B, R] -> [B, n + 1], column n = none
        return torch.cat([col.permute(1, 0, 2).reshape(B, n),
                          torch.full((B, 1), -1, dtype=col.dtype, device=dev)], dim=1)

    nxt = per_utt(recs.prev).to(torch.int64)
    nxt = torch.where(nxt >= 0, nxt, n)
    at = torch.where(handle.best_bp >= 0, handle.best_bp, n)[:, None]
    maxw = min(T, MAX_WALK)
    steps = []
    while len(steps) < maxw:
        for _ in range(min(WALK_CHUNK, maxw - len(steps))):
            steps.append(at)
            at = nxt.gather(1, at)
        if not bool((at < n).any()):
            break
    ids = torch.cat(steps, dim=1)  # [B, steps]
    live = ids < n
    walk = torch.full((maxw + 1, B, 3), -1, dtype=torch.int32, device=dev)
    walk[: ids.shape[1]] = torch.stack([
        per_utt(recs.lemma).gather(1, ids),
        torch.where(live, torch.div(ids, R, rounding_mode="floor"), -1),
        torch.where(live, ids, -1),
    ], dim=-1).transpose(0, 1).to(torch.int32)
    walk[maxw] = handle.best_score.view(torch.int32)[:, None]
    return walk


@dataclasses.dataclass
class DecodeResult:
    """Best-sentence output (ref: Speech::Recognizer's <recognized> data)."""

    segment_name: str
    lemmas: List  # lemma objects in order (incl. silence entries)
    words: List[str]  # eval-relevant orth sequence
    word_ends: List[int]  # frame index of each lemma's end
    score: float
    record_ids: List[int]  # traceback record chain (for lattices)

    @property
    def orth(self) -> str:
        return " ".join(self.words)


class TreeDecoder:
    """Batched offline decoder (ref seam: Search::SearchAlgorithm).

    ``tree`` supplies the lemmas and word-end shape; ``tables`` overrides
    the device tables compiled from it (e.g. carried across from the JAX
    decoder by ``convert.tree_tables_from_jax``). ``bigram_la`` is a
    ``search.lookahead.BigramLookahead`` or its :class:`BigramTables`
    (e.g. from ``convert.bigram_tables_from_jax``); None = unigram-only
    shaping; on a general WFST network (``search/wfst.py``) it is the
    ``reentry`` lookahead of ``lookahead._wordset_general``. ``rnn_fusion``
    (``search.rnn_fusion.build_rnn_fusion``) fuses an RNN LM into the
    first pass; the offline decode sizes its state pools to R x T rows."""

    def __init__(
        self,
        tree: PrefixTree,
        lm_tables: NgramTables,
        cfg: BeamConfig = BeamConfig(),
        bigram_la=None,
        rnn_fusion=None,
        device=None,
        tables: Optional[TreeTables] = None,
    ):
        self.device = resolve(device)
        self.tree = tree
        self.tables = (
            tree_to_device(tree, self.device) if tables is None else tables.to(self.device)
        )
        if bigram_la is None or isinstance(bigram_la, BigramTables):
            self.bla = None if bigram_la is None else bigram_la.to(self.device)
        else:
            self.bla = bigram_to_device(bigram_la, tree, self.device)
        self.lm = lm_tables.to(self.device)
        self.rnn = None if rnn_fusion is None else rnn_fusion.to(self.device)
        self.lm_prep = prepare_lookup(self.lm)
        # word-end selection cannot exceed the number of candidates
        self.cfg = dataclasses.replace(
            cfg, word_end_limit=min(cfg.word_end_limit, cfg.max_hyps * tree.max_word_ends)
        )

    def decode_scores(
        self,
        emissions,  # [B, T, M] acoustic -log scores (scaled)
        n_frames,
        names: Optional[Sequence[str]] = None,
        mesh=None,
        beam_axis: Optional[str] = None,
    ) -> List[DecodeResult]:
        return self.results_from_device(
            self.decode_scores_device(emissions, n_frames, mesh=mesh, beam_axis=beam_axis),
            names,
        )

    def decode_scores_device(self, emissions, n_frames, mesh=None,
                             beam_axis: Optional[str] = None) -> DeviceDecode:
        """Run the batched decode on the decoder's device and return its
        handle without a host transfer; pair with
        :meth:`results_from_device`. Device-resident inputs are used in
        place."""
        if mesh is not None or beam_axis is not None:
            raise NotImplementedError("sharded / beam-partitioned decoding is not ported yet")
        emissions = torch.as_tensor(emissions, dtype=torch.float32, device=self.device)
        n_frames = torch.as_tensor(n_frames, device=self.device).to(torch.int64)
        B, T, _M = emissions.shape
        pool = self.cfg.word_end_limit * T if self.rnn is not None else 0
        carry, recs = _decode_block(
            self._step(), init_carry(B, self.cfg, self.lm, self.device, self.rnn, pool),
            emissions, 0, n_frames)
        return self._finalize(carry, [recs], n_frames)

    def _step(self) -> _Step:
        """The frame step over this decoder's tables and beam."""
        K = self.cfg.max_hyps
        return _Step(self.tables, self.lm, self.lm_prep, self.cfg, self.tree.max_word_ends,
                     min(self.cfg.root_hyps, K), min(self.cfg.branch_hyps or K, K), self.bla,
                     self.rnn)

    def _finalize(self, c: Carry, blocks: Sequence[Records], n_frames: torch.Tensor,
                  live: Optional[torch.Tensor] = None) -> DeviceDecode:
        """The best hypotheses of a decode. Each utterance takes the finals
        frozen at its last declared frame (the start hypothesis when that
        frame was never decoded, as the reference's offline scan does),
        except the utterances a stream marks ``live`` (the counterpart of
        the reference's ``_finalize_stream``): those take the live beam at
        the frontier. The blocks' records join in frame order."""
        if live is not None:
            lv = live[:, None]
            c = c._replace(
                fstate=torch.where(lv, c.state, c.fstate), flm=torch.where(lv, c.lms, c.flm),
                fscore=torch.where(lv, c.score, c.fscore), fbp=torch.where(lv, c.bp, c.fbp))
            if self.rnn is not None:
                c = c._replace(f_rnnrow=torch.where(lv, c.rnn_row, c.f_rnnrow))
        recs = blocks[0] if len(blocks) == 1 else Records(*(torch.cat(r) for r in zip(*blocks)))
        best_score, best_bp, end_cost = _best(self.lm, self.lm_prep, c, self.cfg,
                                              self.tree.num_final_states, self.rnn)
        return DeviceDecode(best_score, best_bp, recs, c, end_cost, self.cfg.word_end_limit,
                            n_frames, self.tree.num_final_states)

    def results_from_device(
        self, handle: DeviceDecode, names: Optional[Sequence[str]] = None
    ) -> List[DecodeResult]:
        """Walk a decode's best paths on the device and assemble results
        from the one payload read to the host (:func:`traceback`)."""
        payload = traceback(handle).cpu().numpy()
        walk = payload[:-1]  # [MAXW, B, 3] (lemma, frame, record id), end-first
        best_score = payload[-1, :, 0].view(np.float32)
        chain = (walk[:, :, 2] >= 0).sum(axis=0)  # each chain's rows lead the walk
        names = names or [f"utt{i}" for i in range(walk.shape[1])]
        results = []
        for b in range(walk.shape[1]):
            lemmas, words, ends, rec_ids = [], [], [], []
            for li, t, rid in walk[: chain[b], b][::-1].tolist():
                if li < 0:
                    continue
                lemma_obj = self.tree.lemmas[li]
                lemmas.append(lemma_obj)
                ends.append(t)
                rec_ids.append(rid)
                words.extend(lemma_obj.eval_tokens())
            results.append(DecodeResult(names[b], lemmas, words, ends,
                                        float(best_score[b]), rec_ids))
        return results
