"""The one traffic generator: it reads a traffic file's parameters.

A traffic file (``benchmark/traffic/<name>.json``) names its ``job`` (a
module of ``benchmark/jobs``) and the parameters below; a new mix is a new
file. Every seed gets the same sizes, in another order, so the seed
changes the data and not the amount of work.

- Corpus traffic (``batch``, ``min_s``, ``max_s``, ``amplitude``):
  utterances of synthetic noise at the configuration's sample rate, in
  batches of ``batch`` in corpus order, each batch padded to its longest.
  Every batch has the same ``batch`` lengths, evenly spaced over
  [min_s, max_s] (the midpoints of ``batch`` equal strata), shuffled by
  the seed.
- Transcripts (``words``: [fewest, most]): each batch's utterances get
  word counts evenly spaced over that range, shuffled by the seed, and
  words drawn from the lexicon.
- Chunk traffic (``batch``, ``frames``, ``pool``): ``pool`` distinct
  batches of ``batch`` x ``frames`` feature vectors with frame labels.
"""

from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 63) - 1


def sub_seed(seed: int, *keys: int) -> int:
    """A seed for one part of a run's data, from the run's seed."""
    return int(np.random.SeedSequence([seed & MASK64, seed >> 63, *keys]).generate_state(1,
               np.uint64)[0]) & MASK64


def batch_lengths(t: dict, sample_rate: int, seed: int, index: int) -> np.ndarray:
    """The samples of each utterance of batch ``index``."""
    B = t["batch"]
    secs = t["min_s"] + (t["max_s"] - t["min_s"]) * (np.arange(B) + 0.5) / B
    order = np.random.default_rng(sub_seed(seed, 1, index)).permutation(B)
    return np.round(secs[order] * sample_rate).astype(np.int64)


def audio_batch(t: dict, sample_rate: int, seed: int, index: int, device):
    """Batch ``index``: ``(samples [B, S_max] float32, lengths [B] int64)``
    on ``device``, zero past each utterance's end, and the host lengths."""
    n = batch_lengths(t, sample_rate, seed, index)
    S = int(n.max())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2, index))
    x = torch.randn(len(n), S, generator=gen, device=device) * t["amplitude"]
    lengths = torch.from_numpy(n).to(device)
    x *= torch.arange(S, device=device)[None, :] < lengths[:, None]
    return x, lengths, n


def transcripts(t: dict, words, seed: int, index: int, key: str = "words"):
    """Batch ``index``'s transcripts: lists of ``words`` entries."""
    lo, hi = t[key]
    B = t["batch"]
    counts = np.round(lo + (hi - lo) * np.arange(B) / max(B - 1, 1)).astype(int)
    rng = np.random.default_rng(sub_seed(seed, 6, index))
    counts = counts[rng.permutation(B)]
    return [[words[j] for j in rng.integers(0, len(words), size=c)] for c in counts]


def chunk_pool(t: dict, in_dim: int, classes: int, seed: int, device):
    """``pool`` batches of ``(features [B, T, D], labels [B, T] int64,
    weights [B, T])`` on ``device``, every row different."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    P, B, T = t["pool"], t["batch"], t["frames"]
    x = torch.randn(P, B, T, in_dim, generator=gen, device=device)
    y = torch.randint(0, classes, (P, B, T), generator=gen, device=device)
    w = torch.ones(P, B, T, device=device)
    return [(x[i], y[i], w[i]) for i in range(P)]
