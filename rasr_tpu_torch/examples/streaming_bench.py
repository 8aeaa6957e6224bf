"""Streaming (online) decode measurement on one CUDA card.

The counterpart of ``examples/streaming_bench.py``: the benchmark setup
(``synthetic.build_setup``: 5k words, 2000 tied states, bench.py's
production beam) scores ``BATCH`` = 64 utterances of ``FRAMES`` = 998
frames of noise on the card with its frontend and GMM scorer, and feeds
the device-resident emissions to ``search.streaming.StreamingDecoder`` in
blocks of 16, 32 and 128 frames. For each block size it reports

* the sustained rate in audio-s/s: the slope between streams of all the
  full blocks and of half of them, the median of ``PAIRS`` pairs (the
  final value read cancels);
* the per-feed latency: the median (and 95th percentile) of the first
  ``LATENCY_FEEDS`` feeds of a stream, each ending in a value read of the
  beam (what a server syncing every block pays; a block of Tb frames must
  take under Tb x 10 ms to keep up);
* the warm ``current_best()`` latency at the end of the stream (records
  joined, frontier finalized, best paths read back to the host);

and asserts that the streamed words, word ends and scores equal the
offline decode's. One JSON line per block size:

    python -m rasr_tpu_torch.examples.streaming_bench
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..device import cuda_device
from ..search.streaming import StreamingDecoder
from ..synthetic import build_setup
from .profile_decode import emissions

BATCH, FRAMES, BLOCKS = 64, 998, (16, 32, 128)
PAIRS, LATENCY_FEEDS, BEST_REPS = 3, 12, 3
#: streamed and offline decodes run the same ops on the same scores
SCORE_RTOL = 1e-6


def _same(got, want) -> bool:
    return all(a.words == b.words and a.word_ends == b.word_ends
               and abs(a.score - b.score) <= SCORE_RTOL * max(1.0, abs(b.score))
               for a, b in zip(got, want))


def run(device, setup=None) -> list:
    """Measure each block size on ``device`` (a CUDA card) over ``setup``
    (``build_setup``'s by default); returns the rows it prints."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the bench times a CUDA card, got {device}")
    s = setup if setup is not None else build_setup(device=device)
    emis = emissions(s, device, BATCH, FRAMES)
    B, T = emis.shape[:2]
    n = torch.full((B,), T, dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    offline = s.decoder.decode_scores(emis, n)
    offline_s = time.perf_counter() - t0
    sd = StreamingDecoder(s.decoder)

    def force() -> float:  # a value read of the live beam: waits for the feeds
        return float(sd._carry.score[:, 0].min())

    rows = []
    for Tb in BLOCKS:
        blocks = [emis[:, i:i + Tb] for i in range(0, T, Tb)]  # the last may be short
        full = T // Tb
        sd.restart(B, n).feed(blocks[0])
        force()
        sd.current_best()

        def stream(k: int) -> float:
            sd.restart(B, n)
            t0 = time.perf_counter()
            for b in blocks[:k]:
                sd.feed(b)
            force()
            return time.perf_counter() - t0

        per_feed = float(np.median([(stream(full) - stream(full // 2)) / (full - full // 2)
                                    for _ in range(PAIRS)]))
        sd.restart(B, n)
        lat = []
        for i, b in enumerate(blocks):
            t0 = time.perf_counter()
            sd.feed(b)
            if i < LATENCY_FEEDS:
                force()
                lat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        sd.current_best()
        best_cold = time.perf_counter() - t0
        best = []
        for _ in range(BEST_REPS):
            t0 = time.perf_counter()
            sd.current_best()
            best.append(time.perf_counter() - t0)
        streamed = sd.finalize()
        if not _same(streamed, offline):
            raise AssertionError(f"block {Tb}: the streamed decode differs from the offline one")
        row = {
            "metric": "streaming_decode", "device": torch.cuda.get_device_name(device),
            "batch": B, "frames": T, "block_frames": Tb,
            "audio_s_per_s": B * Tb * 0.01 / per_feed,
            "per_feed_ms": per_feed * 1e3,
            "per_feed_ms_synced_p50": float(np.median(lat)) * 1e3,
            "per_feed_ms_synced_p95": float(np.quantile(lat, 0.95)) * 1e3,
            "feed_budget_ms": Tb * 10.0,
            "realtime_per_stream": Tb * 0.01 / per_feed,
            "current_best_ms_warm": float(np.median(best)) * 1e3,
            "current_best_ms_cold": best_cold * 1e3,
            "offline_audio_s_per_s": B * T * 0.01 / offline_s,
            "streamed_equals_offline": True,
            "n_words_decoded": float(np.mean([len(r.words) for r in streamed])),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    run(cuda_device())
    return 0


if __name__ == "__main__":
    sys.exit(main())
