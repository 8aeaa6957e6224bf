"""N-gram LM compiled to device-resident hash tables with gather lookups.

Counterpart of ``rasr_tpu/models/lm/ngram_tpu.py``. The ARPA model
compiles once, host-side (numpy), into

* a **state space**: every context listed in the model plus the empty
  context (id 0); these ids ARE the decoder's word histories;
* ``backoff_cost/backoff_state [S]``;
* an open-addressing **transition hash table** keyed by (state, word)
  holding (cost, next state), in buckets of 4 slots whose spill window
  is the bucket and the next one (build-verified).

The host half (:func:`_hash`, :func:`build_tables`,
:func:`state_contexts`, :func:`compile_ngram`) is a JAX-free copy of the
reference's and must produce bit-identical tables. The device half
(:func:`prepare_lookup`, :func:`lookup_prepared`, :func:`lookup`) keeps
its semantics but not its TPU layouts: costs stay float32 columns (no
int32 bit carriers) and there is no 128-lane row packing. It reads both
table layouts: the bucketed one above and the per-slot probed one that
``models/lm/packed.py::compile_packed`` builds (``bucket_bits == 0``).
:func:`save_tables` / :func:`load_tables` keep the reference's npz image,
so either package reads the other's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .arpa import NgramLm

_H1 = np.uint32(0x9E3779B1)
_H2 = np.uint32(0x85EBCA6B)
_M32 = 0xFFFFFFFF


def _hash(state: np.ndarray, word: np.ndarray, mask: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (state.astype(np.uint32) * _H1) ^ (word.astype(np.uint32) * _H2)
        h ^= h >> np.uint32(15)
        h = h * np.uint32(0x2545F491)
        h ^= h >> np.uint32(13)
    return (h & np.uint32(mask)).astype(np.int64)


def hash_torch(state: torch.Tensor, word: torch.Tensor, mask: int) -> torch.Tensor:
    """Device form of :func:`_hash`: the reference's uint32 wraparound
    emulated in int64 masked to 32 bits (torch has no uint32 ``>>`` on
    the CPU). Returns int64 bucket indices."""
    s = state.to(torch.int64) & _M32
    w = word.to(torch.int64) & _M32
    h = ((s * int(_H1)) & _M32) ^ ((w * int(_H2)) & _M32)
    h = h ^ (h >> 15)
    h = (h * 0x2545F491) & _M32
    h = h ^ (h >> 13)
    return h & mask


@dataclasses.dataclass(frozen=True)
class NgramTables:
    """The compiled LM (torch tensors; ``to(device)`` moves them)."""

    key_state: torch.Tensor  # [H] i32, -1 = empty
    key_word: torch.Tensor  # [H] i32
    val_cost: torch.Tensor  # [H] f32
    val_next: torch.Tensor  # [H] i32
    backoff_cost: torch.Tensor  # [S] f32
    backoff_state: torch.Tensor  # [S] i32
    order: int
    max_probe: int
    start_state: int
    end_word: int
    unk_word: int
    num_states: int
    #: the hash selects a BUCKET of 2^bits consecutive slots (entries spill
    #: into the next bucket). 0 = per-slot linear probing: the hash selects
    #: a slot and an entry lies within ``max_probe`` slots after it.
    bucket_bits: int = 0

    @property
    def table_size(self) -> int:
        return self.key_state.shape[0]

    def to(self, device) -> "NgramTables":
        arrays = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **arrays)


def build_tables(
    entries,
    backoff_cost: np.ndarray,
    backoff_state: np.ndarray,
    order: int,
    start_state: int,
    end_word: int,
    unk_word: int,
    max_probe: int = 16,
) -> NgramTables:
    """Hash ``(state, word) -> (cost, next)`` entries into the bucketed
    open-addressing table (bucket of 4 at load factor <= 1; an entry
    lands in its bucket or the next one; grow on failure) and pack it
    with the backoff arrays. Same table as the reference, bit for bit."""
    n = len(entries)
    bucket_bits = 2
    bsz = 1 << bucket_bits
    window = 2 * bsz
    BH = 1
    while BH < max(n, 1):
        BH *= 2

    while True:
        H = BH * bsz
        key_state = np.full(H, -1, np.int32)
        key_word = np.full(H, -1, np.int32)
        val_cost = np.zeros(H, np.float32)
        val_next = np.zeros(H, np.int32)
        worst = 0
        ok = True
        for st, w, cost, nxt in entries:
            h = int(_hash(np.int32(st), np.int32(w), BH - 1)) * bsz
            for p in range(window):
                idx = (h + p) & (H - 1)
                if key_state[idx] < 0:
                    key_state[idx] = st
                    key_word[idx] = w
                    val_cost[idx] = cost
                    val_next[idx] = nxt
                    worst = max(worst, p + 1)
                    break
            else:
                ok = False
                break
        if ok:
            break
        BH *= 2  # spill window exceeded: grow the bucket array

    return NgramTables(
        key_state=torch.from_numpy(key_state),
        key_word=torch.from_numpy(key_word),
        val_cost=torch.from_numpy(val_cost),
        val_next=torch.from_numpy(val_next),
        backoff_cost=torch.from_numpy(backoff_cost.astype(np.float32)),
        backoff_state=torch.from_numpy(backoff_state.astype(np.int32)),
        order=order,
        max_probe=worst,
        start_state=start_state,
        end_word=end_word,
        unk_word=unk_word,
        num_states=backoff_cost.shape[0],
        bucket_bits=bucket_bits,
    )


def state_contexts(lm: NgramLm):
    """The compiled automaton's state space: context tuples in state-id
    order (state 0 = empty context)."""
    return [()] + sorted(g for g in lm.ngrams if len(g) < lm.order)


def compile_ngram(lm: NgramLm, max_probe: int = 16) -> NgramTables:
    """Host-side compilation ARPA dict -> tables."""
    order = lm.order
    contexts = state_contexts(lm)
    state_id: Dict[Tuple[int, ...], int] = {g: i for i, g in enumerate(contexts)}

    def ctx_state(g: Tuple[int, ...]) -> int:
        while g not in state_id:
            g = g[1:]
        return state_id[g]

    S = len(contexts)
    backoff_cost = np.zeros(S, np.float32)
    backoff_state = np.zeros(S, np.int32)
    for g, i in state_id.items():
        if g:
            backoff_cost[i] = lm.ngrams[g][1]
            backoff_state[i] = ctx_state(g[1:])

    entries = []  # (state, word, cost, next_state)
    for gram, (cost, _bo) in lm.ngrams.items():
        h, w = gram[:-1], gram[-1]
        if h not in state_id:
            continue  # unreachable context (its own prefix is unlisted)
        nxt = ctx_state(gram[-(order - 1):]) if order > 1 else 0
        entries.append((state_id[h], w, cost, nxt))

    bos = lm.vocab.get("<s>")
    start = state_id.get((bos,), 0) if bos is not None else 0
    return build_tables(
        entries,
        backoff_cost,
        backoff_state,
        order=order,
        start_state=start,
        end_word=lm.vocab.get("</s>", -1),
        unk_word=lm.vocab.get("<unk>", -1),
        max_probe=max_probe,
    )


#: the per-slot layout replicates each slot's probe window into one row
#: while the four replicated columns (int64 state, word and next, float32
#: cost: 28 bytes per slot and probe) stay within this many bytes; above
#: it, each level gathers its ``max_probe`` slots one probe at a time
REP_WINDOW_BYTES = 512 * 1024 * 1024


class LookupTables(NamedTuple):
    """Gather-side tables built once per decoder by :func:`prepare_lookup`.

    A probe level reads the ``rep_*`` rows of its hash index: for a
    bucketed table ``[BH, 2*bsz]`` (bucket b and b+1 side by side), for a
    per-slot table ``[H, P]`` (slot h and the ``P - 1`` after it). When
    ``probes`` is non-zero the per-slot window was too large to replicate:
    ``rep_*`` are then the flat ``[H]`` columns and a level gathers slot
    ``(h + p) & (H - 1)`` for each ``p < probes``."""

    rep_state: torch.Tensor  # i64
    rep_word: torch.Tensor  # i64
    rep_cost: torch.Tensor  # f32
    rep_next: torch.Tensor  # i64
    bo_cost: torch.Tensor  # [S] f32
    bo_state: torch.Tensor  # [S] i64
    uni_cost: torch.Tensor  # [V+1] f32 (row V: the no-unigram default)
    uni_next: torch.Tensor  # [V+1] i64
    probes: int = 0


def prepare_lookup(tables: NgramTables) -> LookupTables:
    """Build the lookup tables ONCE, outside any frame loop.

    * ``rep_*``: each probe window laid out as one row, so a probe level
      is one row gather: a bucket row pair-replicated with its successor,
      or a slot's ``max_probe`` window (while it fits
      :data:`REP_WINDOW_BYTES`);
    * ``uni_*``: the final backoff level is always the empty context, so
      it is a dense table by word id; words with no unigram hold the
      ``<unk>`` unigram (or cost 99), row V is that default for
      out-of-range ids.
    """
    dev = tables.key_state.device
    H = tables.table_size
    P = max(tables.max_probe, 1)
    probes = 0
    if tables.bucket_bits:
        bsz = 1 << tables.bucket_bits
        BH = H >> tables.bucket_bits

        def rep(col, dtype):
            rows = col.to(dtype).reshape(BH, bsz)
            return torch.cat([rows, torch.roll(rows, -1, dims=0)], dim=1).contiguous()
    elif H * P * 28 <= REP_WINDOW_BYTES:
        window = (torch.arange(H, device=dev)[:, None] + torch.arange(P, device=dev)) & (H - 1)

        def rep(col, dtype):
            return col.to(dtype)[window]
    else:
        probes = P

        def rep(col, dtype):
            return col.to(dtype)

    ks = tables.key_state.cpu().numpy()
    kw = tables.key_word.cpu().numpy()
    vc = tables.val_cost.cpu().numpy()
    vn = tables.val_next.cpu().numpy()
    uni_rows = ks == 0
    V = int(kw[uni_rows].max()) + 1 if uni_rows.any() else 1
    d_cost, d_next = 99.0, 0
    if tables.unk_word >= 0:
        unk_hit = uni_rows & (kw == tables.unk_word)
        if unk_hit.any():
            i = int(np.flatnonzero(unk_hit)[0])
            d_cost, d_next = float(vc[i]), int(vn[i])
    uni_cost = np.full(V + 1, d_cost, np.float32)
    uni_next = np.full(V + 1, d_next, np.int64)
    uni_cost[kw[uni_rows]] = vc[uni_rows]
    uni_next[kw[uni_rows]] = vn[uni_rows]
    return LookupTables(
        rep_state=rep(tables.key_state, torch.int64),
        rep_word=rep(tables.key_word, torch.int64),
        rep_cost=rep(tables.val_cost, torch.float32),
        rep_next=rep(tables.val_next, torch.int64),
        bo_cost=tables.backoff_cost.to(torch.float32),
        bo_state=tables.backoff_state.to(torch.int64),
        uni_cost=torch.from_numpy(uni_cost).to(dev),
        uni_next=torch.from_numpy(uni_next).to(dev),
        probes=probes,
    )


def lookup_prepared(
    tables: NgramTables,
    prep: LookupTables,
    states: torch.Tensor,
    words: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized backing-off lookup: states, words ``[...]`` -> (costs
    f32, next states i64). ``order - 1`` hash-probe levels, then the
    dense unigram level; unknown words get the ``<unk>`` unigram or 99."""
    states = states.to(torch.int64)
    words = words.to(torch.int64)
    H = tables.table_size
    mask = (H >> tables.bucket_bits) - 1  # the bucket or the slot index
    if prep.probes:
        offsets = torch.arange(prep.probes, device=states.device)
    acc = torch.zeros(states.shape, dtype=torch.float32, device=states.device)
    nxt = torch.zeros_like(states)
    found = torch.zeros(states.shape, dtype=torch.bool, device=states.device)
    cur = states
    for _level in range(tables.order - 1):
        h = hash_torch(cur, words, mask)
        if prep.probes:
            h = (h[..., None] + offsets) & (H - 1)  # [..., P] slots
        match = (prep.rep_state[h] == cur[..., None]) & (prep.rep_word[h] == words[..., None])
        # keys are unique in the table: at most one slot of the window hits
        hit_any = match.any(dim=-1)
        hit_cost = torch.where(match, prep.rep_cost[h], 0.0).sum(dim=-1)
        hit_next = torch.where(match, prep.rep_next[h], 0).sum(dim=-1)
        new_hit = hit_any & ~found
        acc = torch.where(new_hit, acc + hit_cost, acc)
        nxt = torch.where(new_hit, hit_next, nxt)
        found = found | hit_any
        # back off where still unfound and not yet at the empty context
        can_bo = ~found & (cur != 0)
        acc = torch.where(can_bo, acc + prep.bo_cost[cur], acc)
        cur = torch.where(can_bo, prep.bo_state[cur], cur)
    V = prep.uni_cost.shape[0] - 1
    u = torch.clamp(words, max=V)
    acc = torch.where(~found, acc + prep.uni_cost[u], acc)
    nxt = torch.where(~found, prep.uni_next[u], nxt)
    return acc, nxt


def lookup(
    tables: NgramTables, states: torch.Tensor, words: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot lookup (builds the lookup tables; keep it out of loops)."""
    return lookup_prepared(tables, prepare_lookup(tables), states, words)


def score_batch(tables: NgramTables, states: torch.Tensor, words: torch.Tensor):
    """Costs and next states of ``(states, words)`` pairs (one-shot)."""
    return lookup(tables, states, words)


# ------------------------------------------------------------- image caching
def save_tables(tables: NgramTables, path: str) -> None:
    """Persist compiled tables in the reference's npz image (hash-table
    construction over millions of n-grams is a build step, not a startup
    step); ``aux`` holds the seven scalars, ``bucket_bits`` last."""
    np.savez_compressed(
        path,
        key_state=tables.key_state.cpu().numpy(),
        key_word=tables.key_word.cpu().numpy(),
        val_cost=tables.val_cost.cpu().numpy(),
        val_next=tables.val_next.cpu().numpy(),
        backoff_cost=tables.backoff_cost.cpu().numpy(),
        backoff_state=tables.backoff_state.cpu().numpy(),
        aux=np.array(
            [tables.order, tables.max_probe, tables.start_state, tables.end_word,
             tables.unk_word, tables.num_states, tables.bucket_bits],
            np.int64,
        ),
    )


def load_tables(path: str) -> NgramTables:
    """Read an image of either package (host tensors, as
    :func:`compile_ngram` returns them). A six-entry ``aux`` (an image
    written before bucketing) means per-slot probing."""
    with np.load(path, allow_pickle=False) as data:
        aux = data["aux"]
        arrays = {k: torch.from_numpy(data[k]) for k in (
            "key_state", "key_word", "val_cost", "val_next", "backoff_cost",
            "backoff_state")}
    return NgramTables(
        **arrays,
        order=int(aux[0]),
        max_probe=int(aux[1]),
        start_state=int(aux[2]),
        end_word=int(aux[3]),
        unk_word=int(aux[4]),
        num_states=int(aux[5]),
        bucket_bits=int(aux[6]) if aux.shape[0] > 6 else 0,
    )
