"""Sequence (time-axis) parallelism: a time-sharded frontend and a blockwise
forced alignment.

Counterpart of ``rasr_tpu/parallel/sequence.py``: very long recordings
(hours of meetings or broadcast) split along time over a mesh axis, one
contiguous chunk per rank.

* :class:`SpFrontend`: each rank frames and pre-emphasizes its chunk of
  the samples with sample halos from its neighbours (1 sample on the
  left, ``frame_length - frame_shift`` on the right; the last rank takes
  the real signal tail), computes its cepstra with the MFCC kernel
  (``ops/kernels/mfcc.py::mfcc_frames``; its plain version on the CPU),
  reduces segment CMVN statistics with ``all_reduce``, and takes frame
  halos for sliding CMVN, deltas and splice, re-applying each segment's
  edge replication after every context stage as the dense frontend does.
* :func:`sp_viterbi_align`: each rank composes its block's min-plus
  transfer matrix ``M[s_end, s_entry]`` over its frames, an
  ``all_gather`` of the P matrices and a short sequential composition
  give each block its entry vector, a second local pass records the
  backpointers, and the backtrace stitches the blocks right to left. It
  costs S times the sequential scan's work (the associative form's
  price): a tool for memory and latency on long utterances, exactly
  equal to ``ops/viterbi.py::viterbi_align``.

The reference moves halos with ``ppermute``; here each halo exchange is
one ``all_gather`` of every rank's two edges (P is small), from which a
rank takes its neighbours'. Every rank passes the full inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.frontend import FeatureFrontend, mfcc_from_frames, num_frames
from ..ops.kernels.mfcc import mfcc_frames
from ..ops.viterbi import BIG
from .mesh import all_gather, all_reduce, axis_index, axis_size, mesh_device


def _halo(x: torch.Tensor, h: int, mesh: DeviceMesh, axis: str):
    """The left neighbour's last ``h`` and the right neighbour's first
    ``h`` frames of ``x`` ``[B, T_loc, ...]``; zeros at the chain's ends."""
    edges = torch.stack([x[:, :h], x[:, -h:]])[None]  # [1, 2, B, h, ...]
    g = all_gather(edges, mesh, axis)  # [P, 2, B, h, ...]
    p, P = axis_index(mesh, axis), axis_size(mesh, axis)
    zero = torch.zeros_like(edges[0, 0])
    return (g[p - 1, 1] if p > 0 else zero), (g[p + 1, 0] if p < P - 1 else zero)


def _reclip(ext: torch.Tensor, base: int, H: int, n: torch.Tensor) -> torch.Tensor:
    """Each segment's edge replication on a buffer ``[B, W, D]`` covering
    global frames ``base - H .. base - H + W``: positions outside row b's
    ``[0, n[b])`` take the true edge frame (within the buffer for every
    rank that holds, or borders, the row's frames; the output mask zeroes
    the clamped rest). The dense frontend's ``edge_fill`` + clipping."""
    W = ext.shape[1]
    g = base + torch.arange(W, device=ext.device) - H
    tgt = torch.minimum(torch.clamp(g[None, :], min=0), torch.clamp(n[:, None] - 1, min=0))
    jj = torch.clamp(tgt - base + H, 0, W - 1)
    return torch.gather(ext, 1, jj[..., None].expand(-1, -1, ext.shape[2]))


def _delta_shift(ext: torch.Tensor, window: int) -> torch.Tensor:
    """One regression-delta order by interior shifts (the caller holds the
    halo and re-clips the edges between orders)."""
    W = ext.shape[1]
    j = torch.arange(W, device=ext.device)
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    acc = torch.zeros_like(ext)
    for i in range(1, window + 1):
        acc = acc + i * (ext[:, torch.clamp(j + i, 0, W - 1)] - ext[:, torch.clamp(j - i, 0, W - 1)])
    return acc / denom


class SpFrontend:
    """Time-sharded :class:`~rasr_tpu_torch.ops.frontend.FeatureFrontend`.

    ``sp(samples [B, S], lengths [B])`` (the full batch on every rank)
    returns this rank's chunk of the features, ``[B, T_loc, D]`` covering
    global frames ``[p * T_loc, (p + 1) * T_loc)`` (frames past the end are
    zero), and ``n_frames [B]``; :meth:`gather` assembles the chunks. The
    features are the dense frontend's up to float32 summation order in
    the CMVN statistics."""

    def __init__(self, frontend: FeatureFrontend, mesh: DeviceMesh, axis: str = "data"):
        self.fe, self.mesh, self.axis = frontend, mesh, axis
        self.P = axis_size(mesh, axis)
        cfg = frontend.cfg
        self._h_norm = cfg.norm_window // 2 if cfg.normalize == "sliding" else 0
        self._h_ctx = frontend.delta_order * 2 + frontend.splice_context  # delta window 2

    def gather(self, chunk: torch.Tensor, t_glob: int) -> torch.Tensor:
        """Every rank's chunk in time order: ``[B, t_glob, D]``."""
        return all_gather(chunk, self.mesh, self.axis, dim=1)[:, :t_glob]

    def __call__(self, samples, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        fe, cfg, P = self.fe, self.fe.cfg, self.P
        dev = mesh_device(self.mesh)
        samples = torch.as_tensor(samples, dtype=torch.float32, device=dev)
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
        B, S = samples.shape
        t_glob = num_frames(S, cfg)
        T_loc = -(-t_glob // P)
        H = max(self._h_norm, self._h_ctx, 1)
        if T_loc < H:
            raise ValueError(f"time chunk {T_loc} frames < required halo {H}: utterance too "
                             f"short for {P}-way sequence parallelism")
        flen, shift = cfg.frame_length, cfg.frame_shift
        C, hr = T_loc * shift, flen - shift
        p = axis_index(self.mesh, self.axis)
        base = p * T_loc
        # the signal padded to P chunks plus the real tail the last frame
        # reads past them (the last rank has no right neighbour)
        sig = torch.nn.functional.pad(samples, (0, max(P * C + hr - S, 0)))
        chunk = sig[:, p * C:(p + 1) * C]
        left, right = _halo(chunk[..., None], max(hr, 1), self.mesh, self.axis)
        if p == P - 1:
            right = sig[:, P * C:P * C + hr, None]
        ext = torch.cat([left[:, -1:, 0], chunk, right[:, :hr, 0]], dim=1)
        pre = ext[:, 1:] - cfg.preemphasis * ext[:, :-1] if cfg.preemphasis else ext[:, 1:]
        frames = pre.unfold(1, flen, shift)[:, :T_loc]
        if frames.is_cuda:
            feats = mfcc_frames(frames, fe.cosw, fe.sinw, fe.kmel, fe.kdct, cfg.log_floor,
                                fe.basis)
        else:
            feats = mfcc_from_frames(frames, fe.params, cfg)

        n = torch.clamp(torch.where(
            lengths >= flen, 1 + torch.div(lengths - flen, shift, rounding_mode="floor"),
            torch.zeros_like(lengths)), max=t_glob)
        g_local = base + torch.arange(T_loc, device=dev)
        mask = (g_local[None, :] < n[:, None]).to(torch.float32)
        m3 = mask[..., None]

        def psum(x):
            return all_reduce(x, self.mesh, self.axis)

        if cfg.normalize == "segment":
            count = torch.clamp(psum(m3.sum(dim=1)), min=1.0)
            mean = psum((feats * m3).sum(dim=1)) / count
            feats = (feats - mean[:, None]) * m3
            if cfg.norm_variance:
                var = psum((feats * feats * m3).sum(dim=1)) / count
                feats = feats * torch.rsqrt(var[:, None] + 1e-8)
        elif cfg.normalize == "sliding":
            h = self._h_norm
            xl, xr = _halo(feats * m3, h, self.mesh, self.axis)
            ml, mr = _halo(m3, h, self.mesh, self.axis)
            x = torch.cat([xl, feats * m3, xr], dim=1)
            m = torch.cat([ml, m3, mr], dim=1)
            # nothing outside the global frame buffer contributes (the dense
            # version's index clipping at [0, T])
            g_ext = base + torch.arange(T_loc + 2 * h, device=dev) - h
            inb = ((g_ext >= 0) & (g_ext < t_glob)).to(torch.float32)[None, :, None]
            x, m = x * inb, m * inb
            hi = torch.arange(T_loc, device=dev) + 2 * h + 1
            lo = torch.arange(T_loc, device=dev)

            def rangesum(v):  # frame j: global window [g - h, g + h]
                c = torch.nn.functional.pad(torch.cumsum(v, dim=1), (0, 0, 1, 0))
                return c[:, hi] - c[:, lo]

            nn_ = torch.clamp(rangesum(m), min=1.0)
            mean = rangesum(x) / nn_
            feats = (feats - mean) * m3
            if cfg.norm_variance:
                var = torch.clamp(rangesum(x * x) / nn_ - mean * mean, min=1e-8)
                feats = feats * torch.rsqrt(var)

        if fe.delta_order or fe.splice_context:
            h = self._h_ctx
            xl, xr = _halo(feats, h, self.mesh, self.axis)
            ext = _reclip(torch.cat([xl, feats, xr], dim=1), base, h, n)
            if fe.delta_order:
                pieces, cur = [ext], ext
                for _ in range(fe.delta_order):
                    cur = _reclip(_delta_shift(cur, 2), base, h, n)
                    pieces.append(cur)
                ext = torch.cat(pieces, dim=-1)
            if fe.splice_context:
                c, W = fe.splice_context, ext.shape[1]
                j = torch.arange(W, device=dev)
                ext = torch.cat([ext[:, torch.clamp(j + off, 0, W - 1)]
                                 for off in range(-c, c + 1)], dim=-1)
            feats = ext[:, h:h + T_loc]
        if fe.lda is not None:
            feats = torch.matmul(feats, fe.lda)
        return feats * m3, n


# ------------------------------------------------------------------ viterbi
def _shift(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """``x`` moved k places up ``dim`` (BIG shifted in)."""
    pad = [0, 0] * (x.dim() - 1 - (dim % x.dim())) + [k, 0]
    return torch.nn.functional.pad(x, pad, value=BIG).narrow(dim, 0, x.shape[dim])


@torch.no_grad()
def sp_viterbi_align(mesh: DeviceMesh, emissions, loop, fwd, skip, init, final, n_frames,
                     axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-sharded forced alignment, equal to ``ops/viterbi.py::viterbi_align``.

    Every rank passes the full ``[B, T, S]`` emissions (-log costs), the
    ``[S]`` or ``[B, S]`` loop / fwd / skip / init / final costs and
    ``n_frames [B]``, and aligns its block of ``ceil(T / P)`` frames.
    Returns ``(best_cost [B], states [B, T])`` on every rank (-1 past each
    utterance's end)."""
    dev = mesh_device(mesh)
    P, p = axis_size(mesh, axis), axis_index(mesh, axis)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype)

    emissions = t(emissions)
    loop, fwd, skip, init, final = (t(a) for a in (loop, fwd, skip, init, final))
    n = t(n_frames, torch.int64)
    B, T, S = emissions.shape
    T_loc = -(-T // P)
    base = p * T_loc
    emis = torch.nn.functional.pad(emissions, (0, 0, 0, P * T_loc - T), value=BIG)
    emis = emis[:, base:base + T_loc].clamp(max=BIG)
    loop, fwd, skip, init, final = (x.expand(B, S) for x in (loop, fwd, skip, init, final))

    # ---- phase 1: the block's transfer matrix M[b, s_end, s_entry]
    eye = torch.where(torch.eye(S, dtype=torch.bool, device=dev), 0.0, BIG)[None]
    M = eye.expand(B, S, S).clone()
    for j in range(T_loc):
        cand = torch.minimum(torch.minimum(M + loop[..., None], _shift(M, 1, 1) + fwd[..., None]),
                             _shift(M, 2, 1) + skip[..., None])
        if base + j == 0:
            cand = eye.expand(B, S, S)  # frame 0: the initial costs, no transition
        new = torch.clamp(cand + emis[:, j, :, None], max=BIG)
        M = torch.where((base + j < n)[:, None, None], new, M)

    # ---- phase 2: the entry vector of each block (P short steps)
    Ms = all_gather(M[None], mesh, axis)  # [P, B, S, S]
    dp = init.clone()
    for b in range(P):
        if b == p:
            entry = dp
        dp = torch.clamp((Ms[b] + dp[:, None, :]).amin(dim=2), max=BIG)

    # ---- phase 3: the local forward from the entry vector, with backpointers
    dp = entry
    bps = torch.zeros((T_loc, B, S), dtype=torch.int64, device=dev)
    fbest = torch.full((B,), BIG, device=dev)
    fstate = torch.zeros((B,), dtype=torch.int64, device=dev)
    for j in range(T_loc):
        if base + j == 0:
            new = dp
        else:
            stacked = torch.stack([dp + loop, _shift(dp, 1, 1) + fwd, _shift(dp, 2, 1) + skip])
            new, bps[j] = stacked.min(dim=0)  # the first minimum, as argmin
        new = torch.clamp(new + emis[:, j], max=BIG)
        dp = torch.where((base + j < n)[:, None], new, dp)
        tot = torch.clamp(dp + final, max=BIG)
        last = base + j == n - 1
        fbest = torch.where(last, tot.min(dim=-1).values, fbest)
        fstate = torch.where(last, tot.min(dim=-1).indices, fstate)

    # exactly one block owns frame n - 1
    own = (n - 1 >= base) & (n - 1 < base + T_loc)
    best = all_reduce(torch.where(own, fbest, torch.full_like(fbest, BIG)), mesh, axis, "min")
    fstate = all_reduce(torch.where(own, fstate, 0), mesh, axis)

    # ---- phase 4: the backtrace stitched right to left (P rounds: a block's
    # exit state is its right neighbour's state before that block's start)
    recv = torch.zeros((B,), dtype=torch.int64, device=dev)
    states = torch.full((B, T_loc), -1, dtype=torch.int64, device=dev)
    for _ in range(P):
        cur = torch.where(own, fstate, recv)
        for j in range(T_loc - 1, -1, -1):
            live = base + j < n
            states[:, j] = torch.where(live, cur, -1)
            if base + j > 0:
                offs = bps[j].gather(1, cur.clamp(min=0)[:, None])[:, 0]
                cur = torch.where(live, cur - offs, cur)
        preds = all_gather(cur[None], mesh, axis)  # [P, B]
        recv = preds[p + 1] if p < P - 1 else torch.zeros_like(cur)
    return best, all_gather(states, mesh, axis, dim=1)[:, :T]
