"""The best-path read of the main path's decode, on one CUDA card.

    python -m rasr_tpu_torch.examples.traceback_bench

The benchmark setup's decoder (``synthetic.build_setup``: 5k words, 2000
tied states, bench.py's production beam) decodes ``BATCH`` = 64
utterances of ``FRAMES`` = 998 frames of its GMM emissions
(``profile_decode.emissions``) once offline and once streamed in blocks
of ``BLOCK`` = 128 frames. Then it times ``REPS`` warm reads of each:

* ``results_from_device(handle)`` of the offline decode's handle (host
  clock around the call, which ends in its read of the device);
* the stream's ``current_best()`` (the frontier finalize, the join of the
  blocks' records and the same read).

It uses only these public calls, so it times whichever version of the
package is on the import path (a parent commit's too, for a before and
after in one call). Prints one JSON line of medians and minimums.
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

BATCH, FRAMES, BLOCK, REPS = 64, 998, 128, 7


def _times(fn) -> list:
    out = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def run(device) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the bench times a CUDA card, got {device}")
    s = build_setup(device=device)
    emis = emissions(s, device, BATCH, FRAMES)
    n = torch.full((BATCH,), FRAMES, dtype=torch.int64, device=device)
    handle = s.decoder.decode_scores_device(emis, n)
    offline = s.decoder.results_from_device(handle)  # cold: the first read
    results_ms = _times(lambda: s.decoder.results_from_device(handle))
    sd = StreamingDecoder(s.decoder).restart(BATCH, n)
    for lo in range(0, FRAMES, BLOCK):
        sd.feed(emis[:, lo:lo + BLOCK])
    streamed = sd.current_best()
    best_ms = _times(sd.current_best)
    if [r.words for r in streamed] != [r.words for r in offline]:
        raise AssertionError("the stream's best paths differ from the offline decode's")
    row = {
        "metric": "best_path_read", "device": torch.cuda.get_device_name(device),
        "batch": BATCH, "frames": FRAMES, "block_frames": BLOCK, "reps": REPS,
        "results_from_device_ms_median": float(np.median(results_ms)),
        "results_from_device_ms_min": min(results_ms),
        "current_best_ms_median": float(np.median(best_ms)),
        "current_best_ms_min": min(best_ms),
        "record_bytes": sum(r.numel() * r.element_size() for r in handle.records),
        "words_per_utterance": float(np.mean([len(r.words) for r in offline])),
        "package": sys.modules[__package__.rsplit(".", 1)[0]].__file__,
    }
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    run(cuda_device())
    return 0


if __name__ == "__main__":
    sys.exit(main())
