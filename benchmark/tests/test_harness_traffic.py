"""The traffic generator is deterministic per seed and gives the stated sizes."""

import json

import numpy as np
import torch

from benchmark import spec, traffic

CORPUS = json.loads((spec.HERE / "traffic" / "corpus-ragged.json").read_text())
CHUNKS = json.loads((spec.HERE / "traffic" / "ce-chunks.json").read_text())


def test_corpus_is_deterministic_per_seed():
    for seed in (0, 2**31 + 5, 3 * 2**40):
        a = traffic.audio_batch(CORPUS, 16000, seed, 3, "cpu")
        b = traffic.audio_batch(CORPUS, 16000, seed, 3, "cpu")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = traffic.audio_batch(CORPUS, 16000, 1, 3, "cpu")
    d = traffic.audio_batch(CORPUS, 16000, 2, 3, "cpu")
    assert not torch.equal(c[0][:, :1000], d[0][:, :1000])


def test_every_batch_holds_the_stated_lengths():
    want = np.round((2.0 + 14.0 * (np.arange(64) + 0.5) / 64) * 16000).astype(np.int64)
    orders = set()
    for seed, index in ((7, 0), (7, 1), (8, 0)):
        n = traffic.batch_lengths(CORPUS, 16000, seed, index)
        assert len(n) == CORPUS["batch"] == 64
        assert np.array_equal(np.sort(n), want)
        assert n.min() >= 2.0 * 16000 and n.max() <= 16.0 * 16000
        orders.add(tuple(n))
    assert len(orders) == 3  # the seed and the batch change the order only


def test_audio_is_zero_past_each_end():
    x, lengths, n = traffic.audio_batch(CORPUS, 16000, 5, 0, "cpu")
    assert x.shape == (64, int(n.max()))
    for row in range(64):
        assert torch.count_nonzero(x[row, n[row]:]) == 0
        assert torch.count_nonzero(x[row, : n[row]]) > 0.999 * n[row]


def test_chunk_pool_rows_all_differ():
    pool = traffic.chunk_pool(CHUNKS, 45, 9001, 11, "cpu")
    assert len(pool) == CHUNKS["pool"]
    x, y, w = pool[0]
    assert x.shape == (32, 400, 45) and y.shape == (32, 400) and w.shape == (32, 400)
    assert int(y.max()) < 9001 and int(y.min()) >= 0
    rows = torch.cat([p[0].reshape(32, -1) for p in pool])
    assert len({tuple(r[:8].tolist()) for r in rows}) == rows.shape[0]
    again = traffic.chunk_pool(CHUNKS, 45, 9001, 11, "cpu")
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(pool, again))
