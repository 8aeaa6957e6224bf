"""Batched forced alignment, in PyTorch.

Counterpart of ``rasr_tpu/align/aligner.py`` (ref: src/Speech/Aligner.*,
Speech::Alignment): per utterance the mapping frame -> (allophone state,
tied class, weight), a whole batch at once. The graphs are padded to a
common state count on the host, the emissions of every graph state are
gathered from the scorer's ``[B, T, M]`` scores on their device, and one
banded Viterbi (or forward-backward) pass aligns the batch there. With a
GMM scorer on the card, the scores come from the fused GMM kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.scorer import FeatureScorer
from ..ops.viterbi import BIG, forward_backward, viterbi_align
from ..utils import profiling
from ..utils.archive import pack_ndarray, unpack_ndarray
from .graph import LinearGraph


@dataclasses.dataclass
class Alignment:
    """Per-frame alignment of one utterance (ref: Speech::Alignment)."""

    segment_name: str
    emission_ids: np.ndarray  # [T] int32 tied-class per frame
    state_indices: np.ndarray  # [T] int32 graph-chain state per frame
    score: float
    weights: Optional[np.ndarray] = None  # [T] posterior weight (Viterbi: 1)

    @property
    def num_frames(self) -> int:
        return self.emission_ids.shape[0]

    def pack(self) -> bytes:
        """``[T, 3]`` float32 (class, state, weight) as a cache-archive
        ndarray: the same bytes as the reference's."""
        arr = np.stack(
            [
                self.emission_ids.astype(np.float32),
                self.state_indices.astype(np.float32),
                self.weights if self.weights is not None else np.ones(self.num_frames, np.float32),
            ],
            axis=1,
        )
        return pack_ndarray(arr)

    @classmethod
    def unpack(cls, name: str, data: bytes, score: float = 0.0) -> "Alignment":
        arr = unpack_ndarray(data)
        return cls(
            segment_name=name,
            emission_ids=arr[:, 0].astype(np.int32),
            state_indices=arr[:, 1].astype(np.int32),
            score=score,
            weights=arr[:, 2],
        )


def linear_segmentation(graphs: Sequence[LinearGraph], n_frames: np.ndarray) -> np.ndarray:
    """Uniform flat-start labels: frames spread evenly over chain states
    (the bootstrap for EM from identical models). Returns labels
    ``[B, T_max]`` (emission class ids, -1 padding)."""
    n_frames = np.asarray(n_frames)
    B = len(graphs)
    T = int(np.max(n_frames))
    labels = np.full((B, T), -1, np.int32)
    for i, g in enumerate(graphs):
        n = int(n_frames[i])
        if n <= 0:
            continue
        S = g.num_states
        idx = np.minimum((np.arange(n) * S) // max(n, 1), S - 1)
        labels[i, :n] = g.emission_ids[idx]
    return labels


def _pad_graphs(graphs: Sequence[LinearGraph]):
    """Stack graphs into padded ``[B, S_max]`` numpy arrays: (emission ids,
    loop, fwd, skip, init, final)."""
    B = len(graphs)
    S = max(g.num_states for g in graphs)
    emission_ids = np.zeros((B, S), np.int32)
    loop = np.full((B, S), BIG, np.float32)
    fwd = np.full((B, S), BIG, np.float32)
    skip = np.full((B, S), BIG, np.float32)
    init = np.full((B, S), BIG, np.float32)
    final = np.full((B, S), BIG, np.float32)
    for i, g in enumerate(graphs):
        n = g.num_states
        emission_ids[i, :n] = g.emission_ids
        loop[i, :n] = g.loop
        fwd[i, :n] = g.fwd
        skip[i, :n] = g.skip
        init[i, :n] = g.init
        final[i, :n] = g.final
    return emission_ids, loop, fwd, skip, init, final


def _gather_emissions(scores: torch.Tensor, emission_ids: torch.Tensor) -> torch.Tensor:
    """``[B, T, M]`` scores + ``[B, S]`` class ids -> ``[B, T, S]`` graph
    emissions."""
    B, T, _ = scores.shape
    idx = emission_ids.to(torch.int64)[:, None, :].expand(B, T, emission_ids.shape[1])
    return scores.gather(2, idx)


def _no_span(name: str, **counts):
    return contextlib.nullcontext()


def _device_graphs(graphs: Sequence[LinearGraph], device):
    """The padded graph arrays as tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in _pad_graphs(graphs))


class BatchAligner:
    """Aligns utterance batches against linear graphs on the scorer's
    device: mode ``'viterbi'`` gives hard alignments, ``'baum-welch'``
    per-frame state posteriors (gamma) as weights."""

    def __init__(self, scorer: FeatureScorer, mode: str = "viterbi"):
        if mode not in ("viterbi", "baum-welch"):
            raise ValueError(f"unknown alignment mode {mode!r}")
        self.scorer = scorer
        self.mode = mode

    def align_scores(
        self,
        scores: torch.Tensor,  # [B, T, M]
        graphs: Sequence[LinearGraph],
        n_frames,
        names: Optional[Sequence[str]] = None,
    ) -> List[Alignment]:
        names = names or [f"utt{i}" for i in range(len(graphs))]
        scores = torch.as_tensor(scores)
        viterbi = self.mode == "viterbi"
        # a Viterbi batch is one span; its reads wait for the card, so
        # aligner.host_us_per_frame takes them out
        span = profiling.span if viterbi else _no_span
        with span("align.viterbi", frames=scores.shape[1]):
            with span("align.read"):
                n_host = np.asarray(torch.as_tensor(n_frames).cpu())
            ids, loop, fwd, skip, init, final = _device_graphs(graphs, scores.device)
            emis = _gather_emissions(scores, ids)
            nf = torch.as_tensor(n_host, dtype=torch.int64, device=scores.device)
            out = []
            if viterbi:
                best, states = viterbi_align(emis, loop, fwd, skip, init, final, nf)
                with span("align.read"):
                    best, states = best.cpu().numpy(), states.cpu().numpy()
                for i, g in enumerate(graphs):
                    n = int(n_host[i])
                    seq = states[i, :n]
                    out.append(Alignment(
                        segment_name=names[i],
                        emission_ids=g.emission_ids[seq],
                        state_indices=seq.astype(np.int32),
                        score=float(best[i]),
                        weights=np.ones(n, np.float32),
                    ))
                return out
        total, gamma = forward_backward(emis, loop, fwd, skip, init, final, nf)
        total, gamma = total.cpu().numpy(), gamma.cpu().numpy()
        for i, g in enumerate(graphs):
            n = int(n_host[i])
            gm = gamma[i, :n, : g.num_states]  # [T, S]
            # hard labels for convenience = argmax posterior; weights = max
            seq = gm.argmax(axis=1)
            out.append(Alignment(
                segment_name=names[i],
                emission_ids=g.emission_ids[seq],
                state_indices=seq.astype(np.int32),
                score=float(total[i]),
                weights=gm.max(axis=1).astype(np.float32),
            ))
        return out

    def align(self, feats, graphs: Sequence[LinearGraph], n_frames,
              names: Optional[Sequence[str]] = None) -> List[Alignment]:
        """Score ``feats`` ``[B, T, D]`` and align them."""
        return self.align_scores(self.scorer(feats), graphs, n_frames, names)

    def gamma(self, feats, graphs: Sequence[LinearGraph], n_frames
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full posterior tensor for EM: (total [B], gamma [B, T, S],
        emission ids [B, S]), numpy."""
        scores = self.scorer(feats)
        emission_ids = _pad_graphs(graphs)[0]
        ids, loop, fwd, skip, init, final = _device_graphs(graphs, scores.device)
        nf = torch.as_tensor(n_frames, dtype=torch.int64).to(scores.device)
        total, gamma = forward_backward(_gather_emissions(scores, ids), loop, fwd, skip,
                                        init, final, nf)
        return total.cpu().numpy(), gamma.cpu().numpy(), emission_ids
