"""Vectorized frame-synchronous beam search over the prefix tree, in PyTorch.

Counterpart of ``rasr_tpu/search/decoder.py`` (slice A: the within-word
network, unigram LM lookahead, the dense branch fan and an n-gram LM in
hash tables). A hypothesis is a dense slot ``(tree_state, lm_state,
score, bp)``; per frame, batched over utterances:

1. expansion: self loop, the two dense arcs, the branch fan of the top
   ``branch_hyps`` hypotheses at fan-out states, and the root fan-out of
   the top ``root_hyps`` hypotheses at the root;
2. the frame's emission score of each candidate's destination state;
3. the acoustic beam;
4. exact recombination by (tree_state, lm_state), keeping each key's
   best score, then histogram top-K;
5. word ends: pre-LM top-R (slot index breaks ties), the LM lookup, the
   word-end beam, traceback records and root re-entry;
6. top-K over the K beam slots plus the R re-entries;
7. utterances past their ``n_frames`` freeze, and each utterance's
   final beam is captured at ``t == n_frames - 1``.

The semantics are the reference's, not its TPU layouts: no int32 bit
carriers, no quarter-row gathers, no sort widths padded to powers of 2.
Every selection is a STABLE sort, so ties break by lowest index as
``lax.top_k`` does, and a CPU and a CUDA decode of the same scores pick
the same hypotheses. The recombination key is ``state * L + lm`` in
int64; when it fits 31 bits it is packed with the score into one sort
key, otherwise two stable sorts give the same order.

The frame loop is a Python loop; ``n_frames`` stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.lm.ngram import LookupTables, NgramTables, lookup_prepared, prepare_lookup
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
        arrays = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **arrays)


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


def tree_to_device(tree: PrefixTree, device="cpu") -> TreeTables:
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

    Options of the reference's later decoder slices raise
    ``NotImplementedError`` in :class:`TreeDecoder`: ``root_select``,
    ``deferred_emission``, ``branch_width``, ``expansion_limit``,
    ``root_arc_limit``, ``word_end_rank_lm`` and
    ``lookahead_update="survivor"``. ``scan_unroll`` has no meaning here
    (PyTorch runs the frame loop eagerly) and ``force_unpacked_keys``
    selects the two-sort recombination, whose results are identical."""

    max_hyps: int = 1024  # histogram pruning cap (K)
    beam: float = 1e9  # acoustic beam width
    word_end_limit: int = 128  # R: word-end survivors / records per frame
    #: relative beam over the R word-end records after the exact LM cost
    word_end_beam: float = 1e9
    word_end_rank_lm: bool = False
    root_hyps: int = 32  # H: root (re-entry) hyps expanded per frame
    branch_hyps: int = 0  # Kb: hyps expanded through branch arcs (0 = K)
    branch_width: int = 0
    expansion_limit: int = 0
    root_arc_limit: int = 0
    root_select: int = 0
    deferred_emission: bool = False
    lm_scale: float = 1.0
    #: weight of the unigram lookahead potential (x lm_scale); exact
    #: potential shaping: path scores unchanged, pruning LM-aware
    lookahead_scale: float = 1.0
    lookahead_corr_scale: float = 1.0
    lookahead_update: str = "arc"
    scan_unroll: int = 1
    force_unpacked_keys: bool = False


_NOT_PORTED = (
    ("root_select", 0), ("deferred_emission", False), ("branch_width", 0),
    ("expansion_limit", 0), ("root_arc_limit", 0), ("word_end_rank_lm", False),
    ("lookahead_update", "arc"),
)


def _check_ported(cfg: BeamConfig) -> None:
    for name, default in _NOT_PORTED:
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"BeamConfig.{name}={getattr(cfg, name)!r} is not ported yet"
            )


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


class Records(NamedTuple):
    """Per-frame word-end records ``[T, B, R]`` (the traceback store)."""

    lemma: torch.Tensor  # i64, -1 = none
    score: torch.Tensor  # f32
    prev: torch.Tensor  # i64 predecessor record id, -1 = start
    lmcost: torch.Tensor  # f32
    word: torch.Tensor  # i64
    lm: torch.Tensor  # i64 LM state after the word


def init_carry(B: int, cfg: BeamConfig, lm: NgramTables, device) -> Carry:
    """One live hypothesis per utterance at the tree root in the LM start
    state; every other slot BIG."""
    K = cfg.max_hyps
    state0 = torch.zeros((B, K), dtype=torch.int64, device=device)
    lm0 = torch.full((B, K), lm.start_state, dtype=torch.int64, device=device)
    score0 = torch.full((B, K), BIG, dtype=torch.float32, device=device)
    score0[:, 0] = 0.0
    bp0 = torch.full((B, K), -1, dtype=torch.int64, device=device)
    return Carry(state0, lm0, score0, bp0, state0, lm0, score0, bp0)


class _Step:
    """The per-frame step over one decoder's tables (built once per
    decode: the shaped cost columns are loop-invariant)."""

    def __init__(self, tree: TreeTables, lm: NgramTables, prep: LookupTables,
                 cfg: BeamConfig, wmax: int, hroot: int, kbranch: int):
        self.tree, self.lm, self.prep, self.cfg = tree, lm, prep, cfg
        self.wmax, self.hroot, self.kbranch = wmax, hroot, kbranch
        use_la = tree.has_lookahead and cfg.lookahead_scale != 0.0
        la_coeff = cfg.lm_scale * cfg.lookahead_scale

        def shaped(cost, dla):
            return cost + la_coeff * dla if use_la else cost

        self.d1_cost = shaped(tree.dense1_cost, tree.dense1_dla)
        self.d2_cost = shaped(tree.dense2_cost, tree.dense2_dla)
        self.br_cost = shaped(tree.branch_cost, tree.branch_dla)
        self.root_cost = shaped(tree.root_cost, tree.root_dla)
        # the unigram-potential undo at word ends is a per-state constant
        # -la_coeff * (la[s] - la[root]), folded into the word-end costs
        self.we_cost = tree.we_cost
        if use_la:
            self.we_cost = tree.we_cost - la_coeff * (tree.la - tree.la[0])[:, None]
        self.br_ptr = tree.branch_ptr[:-1]
        self.slots = torch.arange(tree.branch_degree, device=tree.la.device)
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

    def __call__(self, c: Carry, emis_t: torch.Tensor, t: int,
                 n_frames: torch.Tensor, recs: Records) -> Carry:
        tree, cfg = self.tree, self.cfg
        SENT = tree.sentinel
        K, R, L = cfg.max_hyps, cfg.word_end_limit, self.L
        B = c.state.shape[0]
        active = (t < n_frames)[:, None]
        state, lms, score, bp = c.state, c.lms, c.score, c.bp

        def emis(cls):
            return emis_t.gather(1, cls)

        # ---- expansion: loop, dense arcs
        c_loop = score + tree.loop_cost[state] + emis(tree.emission_class[state])
        d1 = tree.dense1_dst[state]
        c_d1 = score + self.d1_cost[state] + emis(tree.dense1_cls[state])
        d2 = tree.dense2_dst[state]
        c_d2 = score + self.d2_cost[state] + emis(tree.dense2_cls[state])

        # ---- branch fan: top-Kb hyps at fan-out states, Db arcs each
        br_sel = torch.where(tree.branch_deg[state] > 0, score, BIG)
        bidx = _stable_order(br_sel, self.kbranch)
        b_score = br_sel.gather(1, bidx)
        b_state = state.gather(1, bidx)
        Db = tree.branch_degree
        ok = self.slots < tree.branch_deg[b_state][..., None]  # [B,Kb,Db]
        bi = torch.where(ok, self.br_ptr[b_state][..., None] + self.slots, 0)
        br_state = torch.where(ok, tree.branch_dst[bi], SENT).reshape(B, -1)
        br_cost = torch.where(ok, self.br_cost[bi], BIG)
        c_br = (b_score[..., None] + br_cost).reshape(B, -1) + emis(
            torch.where(ok, tree.branch_cls[bi], 0).reshape(B, -1)
        )
        br_lm = lms.gather(1, bidx).repeat_interleave(Db, dim=1)
        br_bp = bp.gather(1, bidx).repeat_interleave(Db, dim=1)

        # ---- root fan-out: the best H root hyps expand every root arc
        H, G = self.hroot, tree.root_degree
        root_sel = torch.where(state == 0, score, BIG)
        hidx = _stable_order(root_sel, H)
        h_score = root_sel.gather(1, hidx)  # ascending: h=0 is the best
        emis_root = emis_t[:, tree.root_cls]  # [B,G]
        c_root = (h_score[:, :, None] + self.root_cost) + emis_root[:, None, :]
        root_state = tree.root_dst.expand(B, H, G).reshape(B, H * G)
        root_lm = lms.gather(1, hidx).repeat_interleave(G, dim=1)
        root_bp = bp.gather(1, hidx).repeat_interleave(G, dim=1)

        cand_state = torch.cat([state, d1, d2, br_state, root_state], dim=1)
        cand_lm = torch.cat([lms, lms, lms, br_lm, root_lm], dim=1)
        cand_bp = torch.cat([bp, bp, bp, br_bp, root_bp], dim=1)
        cand_score = torch.clamp(
            torch.cat([c_loop, c_d1, c_d2, c_br, c_root.reshape(B, H * G)], dim=1),
            max=BIG,
        )

        # ---- acoustic beam
        best = cand_score.min(dim=1, keepdim=True).values
        cand_score = torch.where(cand_score > best + cfg.beam, BIG, cand_score)

        # ---- recombination + histogram top-K
        sel, n_score = self._recombine_topk(
            cand_state * L + cand_lm, cand_score, min(K, cand_score.shape[1])
        )
        n_state = torch.where(n_score >= BIG / 2, SENT, cand_state.gather(1, sel))
        n_lm = cand_lm.gather(1, sel)
        n_bp = cand_bp.gather(1, sel)

        # ---- word ends: pre-LM top-R (ties by slot index)
        W = self.wmax
        if W == 1:
            pre = torch.where(
                tree.we_word[n_state, 0] != WORD_NONE,
                n_score + self.we_cost[n_state, 0], BIG,
            )
            ridx = _stable_order(pre, R)
            r_pre = pre.gather(1, ridx)
            r_src = n_state.gather(1, ridx)
            r_slot = torch.zeros_like(r_src)
            r_srclm = n_lm.gather(1, ridx)
            r_srcbp = n_bp.gather(1, ridx)
        else:
            # two-stage exact top-R: word-end slots are cost-sorted per
            # state, so slot 0 bounds its state's other slots
            pre0 = torch.where(
                tree.we_word[n_state, 0] != WORD_NONE,
                n_score + self.we_cost[n_state, 0], BIG,
            )
            Rh = min(R, pre0.shape[1])
            hsel = _stable_order(pre0, Rh)
            s_r = n_state.gather(1, hsel)
            pre = torch.where(
                tree.we_word[s_r] != WORD_NONE,
                n_score.gather(1, hsel)[..., None] + self.we_cost[s_r], BIG,
            ).reshape(B, Rh * W)
            ridx = _stable_order(pre, R)
            r_pre = pre.gather(1, ridx)
            hr = torch.div(ridx, W, rounding_mode="floor")
            r_slot = ridx % W
            r_src = s_r.gather(1, hr)
            r_srclm = n_lm.gather(1, hsel.gather(1, hr))
            r_srcbp = n_bp.gather(1, hsel.gather(1, hr))
        r_word = tree.we_word[r_src, r_slot]
        r_lemma = tree.we_lemma[r_src, r_slot]
        r_next = tree.we_next[r_src, r_slot]

        is_lm_word = r_word >= 0
        lm_cost, lm_next = lookup_prepared(
            self.lm, self.prep, r_srclm, torch.clamp(r_word, min=0)
        )
        r_lmcost = torch.where(is_lm_word, cfg.lm_scale * lm_cost, 0.0)
        r_newlm = torch.where(is_lm_word, lm_next, r_srclm)
        r_score = torch.where(r_pre < BIG / 2, r_pre + r_lmcost, BIG)
        if cfg.word_end_beam < 1e8:
            we_best = r_score.min(dim=1, keepdim=True).values
            r_score = torch.where(r_score > we_best + cfg.word_end_beam, BIG, r_score)
        r_valid = (r_score < BIG / 2) & active

        rec_id = t * R + torch.arange(R, device=r_score.device).expand(B, R)
        re_state = torch.where(r_valid, r_next, SENT)
        re_score = torch.where(r_valid, r_score, BIG)

        # ---- merge the word-end re-entries into the beam
        m_score = torch.cat([n_score, re_score], dim=1)
        midx = _stable_order(m_score, K)
        f_score = m_score.gather(1, midx)
        f_state = torch.where(
            f_score >= BIG / 2, SENT, torch.cat([n_state, re_state], dim=1).gather(1, midx)
        )
        f_lm = torch.cat([n_lm, r_newlm], dim=1).gather(1, midx)
        f_bp = torch.cat([n_bp, rec_id], dim=1).gather(1, midx)

        # ---- freeze finished utterances, capture finals at their last frame
        state = torch.where(active, f_state, state)
        lms = torch.where(active, f_lm, lms)
        score = torch.where(active, f_score, score)
        bp = torch.where(active, f_bp, bp)
        is_last = (t == n_frames - 1)[:, None]

        recs.lemma[t] = torch.where(r_valid, r_lemma, -1)
        recs.score[t] = torch.where(r_valid, r_score, BIG)
        recs.prev[t] = torch.where(r_valid, r_srcbp, -1)
        recs.lmcost[t] = r_lmcost
        recs.word[t] = torch.where(r_valid, r_word, WORD_NONE)
        recs.lm[t] = torch.where(r_valid, r_newlm, -1)
        return Carry(
            state, lms, score, bp,
            torch.where(is_last, state, c.fstate),
            torch.where(is_last, lms, c.flm),
            torch.where(is_last, score, c.fscore),
            torch.where(is_last, bp, c.fbp),
        )


class DeviceDecode(NamedTuple):
    """Handle of one dispatched decode: the best hypothesis per utterance,
    the records its traceback walks and the final beams with their
    ``</s>`` costs (the lattice's inputs). Each handle owns its records."""

    best_score: torch.Tensor  # [B] f32
    best_bp: torch.Tensor  # [B] i64
    records: Records
    finals: Carry
    end_cost: torch.Tensor  # [B, K] scaled </s> cost of the finals
    word_end_limit: int


def _best_and_records(lm, prep, recs: Records, c: Carry, cfg: BeamConfig,
                      nfinal: int = 1) -> DeviceDecode:
    """Final best-hypothesis selection (the ``</s>`` cost applied to
    complete hypotheses at a final state; the best incomplete one when
    there is none)."""
    B, K = c.fstate.shape
    end_cost, _ = lookup_prepared(
        lm, prep, c.flm, torch.full_like(c.flm, max(lm.end_word, 0))
    )
    end_cost = cfg.lm_scale * end_cost if lm.end_word >= 0 else torch.zeros_like(end_cost)
    final_total = torch.where(c.fstate < nfinal, c.fscore + end_cost, BIG)
    best_idx = _first_argmin(final_total)[:, None]
    best_score = final_total.gather(1, best_idx)[:, 0]
    best_bp = c.fbp.gather(1, best_idx)[:, 0]
    fb_idx = _first_argmin(c.fscore)[:, None]
    incomplete = best_score >= BIG / 2
    best_score = torch.where(incomplete, c.fscore.gather(1, fb_idx)[:, 0], best_score)
    best_bp = torch.where(incomplete, c.fbp.gather(1, fb_idx)[:, 0], best_bp)
    return DeviceDecode(best_score, best_bp, recs, c, end_cost, cfg.word_end_limit)


def _walk(best_bp: np.ndarray, lemma: np.ndarray, prev: np.ndarray, R: int,
          maxw: int):
    """Traceback walk (host): per utterance, the (lemma, frame, record)
    chain from the best hypothesis back to the start, end-first."""
    out = []
    for b, bp in enumerate(best_bp):
        chain = []
        while bp >= 0 and len(chain) < maxw:
            t, r = divmod(int(bp), R)
            chain.append((int(lemma[t, b, r]), t, int(bp)))
            bp = prev[t, b, r]
        out.append(chain)
    return out


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
    decoder by ``convert.tree_tables_from_jax``)."""

    def __init__(
        self,
        tree: PrefixTree,
        lm_tables: NgramTables,
        cfg: BeamConfig = BeamConfig(),
        bigram_la=None,
        rnn_fusion=None,
        device="cpu",
        tables: Optional[TreeTables] = None,
    ):
        if bigram_la is not None:
            raise NotImplementedError("bigram lookahead is not ported yet")
        if rnn_fusion is not None:
            raise NotImplementedError("RNN-LM fusion is not ported yet")
        _check_ported(cfg)
        self.device = torch.device(device)
        self.tree = tree
        self.tables = (
            tree_to_device(tree, self.device) if tables is None else tables.to(self.device)
        )
        self.lm = lm_tables.to(self.device)
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
        cfg = self.cfg
        emissions = torch.as_tensor(emissions, dtype=torch.float32, device=self.device)
        n_frames = torch.as_tensor(n_frames, device=self.device).to(torch.int64)
        B, T, _M = emissions.shape
        K, R = cfg.max_hyps, cfg.word_end_limit
        kbranch = min(cfg.branch_hyps or K, K)
        step = _Step(self.tables, self.lm, self.lm_prep, cfg, self.tree.max_word_ends,
                     min(cfg.root_hyps, K), kbranch)

        def rec(dtype, fill):
            return torch.full((T, B, R), fill, dtype=dtype, device=self.device)

        recs = Records(rec(torch.int64, -1), rec(torch.float32, BIG), rec(torch.int64, -1),
                       rec(torch.float32, 0.0), rec(torch.int64, WORD_NONE),
                       rec(torch.int64, -1))
        carry = init_carry(B, cfg, self.lm, self.device)
        for t in range(T):
            carry = step(carry, emissions[:, t], t, n_frames, recs)
        return _best_and_records(self.lm, self.lm_prep, recs, carry, cfg,
                                 self.tree.num_final_states)

    def results_from_device(
        self, handle: DeviceDecode, names: Optional[Sequence[str]] = None
    ) -> List[DecodeResult]:
        """Pull a decode's best paths to the host and assemble results."""
        best_score = handle.best_score.cpu().numpy()
        best_bp = handle.best_bp.cpu().numpy()
        lemma = handle.records.lemma.cpu().numpy()
        prev = handle.records.prev.cpu().numpy()
        T = lemma.shape[0]
        names = names or [f"utt{i}" for i in range(len(best_bp))]
        chains = _walk(best_bp, lemma, prev, handle.word_end_limit, min(T, 512))
        results = []
        for b, chain in enumerate(chains):
            lemmas, words, ends, rec_ids = [], [], [], []
            for li, t, rid in reversed(chain):
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
