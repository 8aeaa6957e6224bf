"""Packed array-backed n-gram LM (production scale).

The pure-python :class:`NgramLm` keeps a dict of tuples — fine for test
LMs, hopeless for multi-gigabyte 4-gram models. This module holds the
production path: flat sorted arrays per order (as emitted by the native
ARPA parser, native/arpa.cc -> .lmbin), scored host-side via numpy
binary search, and compiled into the decoder's hash tables without ever
materializing python objects per n-gram.

(ref: src/Lm/ArpaLm.* image/dump caching — the reference also converts
ARPA text into a packed binary image for fast reload.)

The port's copy of ``rasr_tpu/models/lm/packed.py``: the host half is the
same numpy, the ARPA parse goes through the port's binding of the same
native parser (``utils/native.py``), and :func:`compile_packed` returns
the port's host :class:`~.ngram.NgramTables` in the per-slot layout.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...utils.native import arpa_to_lmbin
from .arpa import NgramLm
from .interface import History, LanguageModel
from .ngram import NgramTables, _hash

MAGIC = b"RLMB1\x00\x00\x00"


class PackedNgramLm(LanguageModel):
    """Arrays per order: ids [N, n] (rows sorted lexicographically),
    cost [N], backoff [N]."""

    def __init__(
        self,
        order: int,
        vocab: Dict[str, int],
        ids: List[np.ndarray],
        cost: List[np.ndarray],
        backoff: List[np.ndarray],
    ):
        self.order = order
        self.vocab = vocab
        self.inv_vocab = {i: w for w, i in vocab.items()}
        self.ids = ids  # index 0 -> unigrams [N,1], ...
        self.cost = cost
        self.backoff = backoff
        self._bos = vocab.get("<s>")
        self._unk = vocab.get("<unk>")
        # radix keys for binary search: pack each row into a single u64
        # (valid while vocab < 2^21 for trigram rows; higher orders use
        # lexicographic row search)
        self._keys = []
        V = len(vocab) + 1
        self._radix_ok = []
        for n, idarr in enumerate(self.ids, start=1):
            if V**n < 2**63:
                key = np.zeros(idarr.shape[0], np.int64)
                for c in range(n):
                    key = key * V + idarr[:, c]
                self._keys.append(key)
                self._radix_ok.append(True)
            else:
                self._keys.append(None)
                self._radix_ok.append(False)
        self._V = V

    # ----------------------------------------------------------- search
    def _find(self, gram: Tuple[int, ...]) -> int:
        """Row index of gram in its order's arrays, or -1."""
        n = len(gram)
        if n == 0 or n > self.order:
            return -1
        arr = self.ids[n - 1]
        if arr.shape[0] == 0:
            return -1
        if self._radix_ok[n - 1]:
            key = 0
            for g in gram:
                key = key * self._V + g
            keys = self._keys[n - 1]
            pos = np.searchsorted(keys, key)
            if pos < keys.shape[0] and keys[pos] == key:
                return int(pos)
            return -1
        # lexicographic fallback
        lo, hi = 0, arr.shape[0]
        row = np.asarray(gram, np.int32)
        while lo < hi:
            mid = (lo + hi) // 2
            cmp = 0
            for c in range(n):
                if arr[mid, c] != row[c]:
                    cmp = -1 if arr[mid, c] < row[c] else 1
                    break
            if cmp < 0:
                lo = mid + 1
            elif cmp > 0:
                hi = mid
            else:
                return mid
        return -1

    # ------------------------------------------------------------ LM api
    def start_history(self) -> History:
        return (self._bos,) if self._bos is not None else ()

    def extended_history(self, history: History, word: int) -> History:
        h = (tuple(history) + (word,))[-(self.order - 1):] if self.order > 1 else ()
        while h and self._find(h) < 0:
            h = h[1:]
        return h

    def score(self, history: History, word: int) -> float:
        if word not in self.inv_vocab:
            if self._unk is None:
                return 99.0
            word = self._unk
        h = tuple(history)[-(self.order - 1):] if self.order > 1 else ()
        acc = 0.0
        while True:
            row = self._find(h + (word,))
            if row >= 0:
                return acc + float(self.cost[len(h)][row])
            if not h:
                if self._unk is not None and word != self._unk:
                    word = self._unk
                    continue
                return acc + 99.0
            ctx = self._find(h)
            if ctx >= 0:
                acc += float(self.backoff[len(h) - 1][ctx])
            h = h[1:]

    # ----------------------------------------------------------------- io
    @classmethod
    def load_lmbin(cls, path: str) -> "PackedNgramLm":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:8] != MAGIC:
            raise IOError(f"{path}: not a RLMB1 file")
        off = 8
        order, vs = struct.unpack_from("<II", data, off)
        off += 8
        vocab: Dict[str, int] = {}
        for i in range(vs):
            (ln,) = struct.unpack_from("<I", data, off)
            off += 4
            vocab[data[off : off + ln].decode()] = i
            off += ln
        ids, cost, backoff = [], [], []
        for n in range(1, order + 1):
            (count,) = struct.unpack_from("<Q", data, off)
            off += 8
            idarr = np.frombuffer(data, np.int32, count * n, off).reshape(count, n)
            off += 4 * count * n
            c = np.frombuffer(data, np.float32, count, off)
            off += 4 * count
            b = np.frombuffer(data, np.float32, count, off)
            off += 4 * count
            ids.append(idarr.copy())
            cost.append(c.copy())
            backoff.append(b.copy())
        return cls(order, vocab, ids, cost, backoff)

    @classmethod
    def from_arpa(cls, path: str, cache: Optional[str] = None) -> "PackedNgramLm":
        """Parse via the native parser (building a .lmbin next to the
        ARPA as an image cache); falls back to the python reader."""
        lmbin = cache or (path + ".lmbin")
        import os

        if not os.path.exists(lmbin):
            if not arpa_to_lmbin(path, lmbin):
                return cls.from_ngram_lm(NgramLm.read_arpa(path))
        return cls.load_lmbin(lmbin)

    @classmethod
    def from_ngram_lm(cls, lm: NgramLm) -> "PackedNgramLm":
        """Pure-python conversion (fallback and test path)."""
        ids, cost, backoff = [], [], []
        for n in range(1, lm.order + 1):
            grams = sorted(g for g in lm.ngrams if len(g) == n)
            idarr = np.asarray(grams, np.int32).reshape(len(grams), n)
            c = np.asarray([lm.ngrams[g][0] for g in grams], np.float32)
            b = np.asarray([lm.ngrams[g][1] for g in grams], np.float32)
            ids.append(idarr)
            cost.append(c)
            backoff.append(b)
        return cls(lm.order, dict(lm.vocab), ids, cost, backoff)


def compile_packed(lm: PackedNgramLm, max_probe: int = 16):
    """Packed arrays -> decoder NgramTables, vectorized (no python dicts).

    Mirrors ngram.compile_ngram but builds the hash table
    with numpy bulk operations — the production path for big LMs. The
    tables are per-slot probed (``bucket_bits == 0``): each entry lies
    within ``max_probe`` slots after its hash slot.
    """
    order = lm.order
    # states: empty context + every gram of order < n
    state_rows = [np.zeros((1, 0), np.int32)] + [lm.ids[n] for n in range(order - 1)]
    # state id layout: 0 = empty, then per order blocks in sorted order
    offsets = [0, 1]
    for n in range(order - 1):
        offsets.append(offsets[-1] + lm.ids[n].shape[0])
    S = offsets[-1]

    def state_of_rows(rows: np.ndarray) -> np.ndarray:
        """Map context rows [N, k] (fixed k) to state ids with suffix
        backoff for missing contexts."""
        N, k = rows.shape
        out = np.zeros(N, np.int64)
        remaining = np.arange(N)
        cur = rows
        kk = k
        while kk > 0 and remaining.size:
            found, pos = _rows_find(lm, cur, kk)
            hit = found
            out[remaining[hit]] = offsets[kk] + pos[hit]
            remaining = remaining[~hit]
            cur = cur[~hit][:, 1:]
            kk -= 1
        # kk == 0 -> empty context id 0 (already zero)
        return out

    def _rows_find(lm, rows, k):
        """(found mask, row indices) of rows in order-k gram arrays."""
        if rows.shape[0] == 0:
            return np.zeros(0, bool), np.zeros(0, np.int64)
        V = lm._V
        if lm._radix_ok[k - 1]:
            keys = lm._keys[k - 1]
            if keys.shape[0] == 0:  # empty order (sparse ARPA section)
                return np.zeros(rows.shape[0], bool), np.zeros(rows.shape[0], np.int64)
            key = np.zeros(rows.shape[0], np.int64)
            for c in range(k):
                key = key * V + rows[:, c]
            pos = np.searchsorted(keys, key)
            pos_c = np.minimum(pos, keys.shape[0] - 1)
            found = keys[pos_c] == key
            return found, pos_c
        found = np.zeros(rows.shape[0], bool)
        pos = np.zeros(rows.shape[0], np.int64)
        for i, row in enumerate(rows):
            r = lm._find(tuple(int(x) for x in row))
            found[i] = r >= 0
            pos[i] = max(r, 0)
        return found, pos

    # backoff arrays
    backoff_cost = np.zeros(S, np.float32)
    backoff_state = np.zeros(S, np.int32)
    for n in range(order - 1):
        lo = offsets[n + 1]
        cnt = lm.ids[n].shape[0]
        backoff_cost[lo : lo + cnt] = lm.backoff[n]
        if n == 0:
            backoff_state[lo : lo + cnt] = 0
        else:
            backoff_state[lo : lo + cnt] = state_of_rows(lm.ids[n][:, 1:])

    # transitions: every gram (h, w) with h a state
    ent_state: List[np.ndarray] = []
    ent_word: List[np.ndarray] = []
    ent_cost: List[np.ndarray] = []
    ent_next: List[np.ndarray] = []
    for n in range(order):  # gram order n+1
        g = lm.ids[n]
        if g.shape[0] == 0:
            continue
        h = g[:, :-1]
        w = g[:, -1]
        if n == 0:
            st = np.zeros(g.shape[0], np.int64)
            ok = np.ones(g.shape[0], bool)
        else:
            ok, pos = _rows_find(lm, h, n)
            st = offsets[n] + pos
        nxt_rows = g[:, max(0, g.shape[1] - (order - 1)):]
        nxt = state_of_rows(nxt_rows) if order > 1 else np.zeros(g.shape[0], np.int64)
        ent_state.append(st[ok].astype(np.int32))
        ent_word.append(w[ok].astype(np.int32))
        ent_cost.append(lm.cost[n][ok])
        ent_next.append(nxt[ok].astype(np.int32))
    states = np.concatenate(ent_state)
    words = np.concatenate(ent_word)
    costs = np.concatenate(ent_cost)
    nexts = np.concatenate(ent_next)
    n_entries = states.shape[0]

    H = 1
    while H < 4 * max(n_entries, 1):
        H *= 2
    while True:
        key_state = np.full(H, -1, np.int32)
        key_word = np.full(H, -1, np.int32)
        val_cost = np.zeros(H, np.float32)
        val_next = np.zeros(H, np.int32)
        slots = _hash(states.astype(np.int32), words.astype(np.int32), H - 1)
        pending = np.arange(n_entries)
        worst = 0
        ok_all = True
        for probe in range(max_probe):
            if pending.size == 0:
                break
            idx = (slots[pending] + probe) & (H - 1)
            # first claimant per slot wins this round
            order_ix = np.argsort(idx, kind="stable")
            sorted_idx = idx[order_ix]
            first = np.ones(sorted_idx.shape[0], bool)
            first[1:] = sorted_idx[1:] != sorted_idx[:-1]
            winners = order_ix[first & (key_state[sorted_idx] < 0)]
            wi = idx[winners]
            free = key_state[wi] < 0
            winners = winners[free]
            wi = wi[free]
            e = pending[winners]
            key_state[wi] = states[e]
            key_word[wi] = words[e]
            val_cost[wi] = costs[e]
            val_next[wi] = nexts[e]
            worst = probe + 1
            placed = np.zeros(pending.shape[0], bool)
            placed[winners] = True
            pending = pending[~placed]
        if pending.size == 0:
            break
        H *= 2  # grow and retry

    bos = lm.vocab.get("<s>")
    start = 0
    if bos is not None:
        f, p = _rows_find(lm, np.asarray([[bos]], np.int32), 1)
        if f[0]:
            start = int(offsets[1] + p[0])
    return NgramTables(
        key_state=torch.from_numpy(key_state),
        key_word=torch.from_numpy(key_word),
        val_cost=torch.from_numpy(val_cost),
        val_next=torch.from_numpy(val_next),
        backoff_cost=torch.from_numpy(backoff_cost),
        backoff_state=torch.from_numpy(backoff_state),
        order=order,
        max_probe=worst,
        start_state=start,
        end_word=lm.vocab.get("</s>", -1),
        unk_word=lm.vocab.get("<unk>", -1),
        num_states=S,
    )
