"""Fused word-end block on one CUDA card: the kernel against its plain version.

The port's counterpart of ``examples/pallas_wordend_microbench.py``: the
same shapes (B=64 utterances, KW=1536 word-end slots, a 56,433-row combo
table, 2000 emission classes, a 12-column state pack) and the same
``default_rng(0)`` draws in the same order. Runs the plain torch version
(``xla_block``'s transcription) and the hand-written CUDA kernel on the
same tensors, asserts that all six outputs are bit-equal, times both with
CUDA events (``us``: a call as the caller pays for it, host dispatch
included; ``device_us``: the same calls replayed from a CUDA graph, so
device time alone) and prints one JSON line per variant:

    python -m rasr_tpu_torch.examples.wordend_microbench

Nothing catches a kernel failure: a failed build or launch raises, and a
disagreement exits non-zero.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import cuda_device, cuda_graph_ms, cuda_ms
from ..ops.kernels.wordend import BIG, wordend_block, wordend_block_plain

SHAPE = dict(B=64, KW=1536, S1=56433, C=2000, C_sp=12)

REPS = 30  # calls per timing


def make_inputs(B, KW, S1, C, C_sp, seed=0):
    """(w_state, w_score, combo, emis) as numpy arrays, drawn as the JAX
    example draws them."""
    rng = np.random.default_rng(seed)
    combo = np.zeros((S1, max(24, 8 + C_sp)), np.int32)
    combo[:, 0] = rng.integers(-1, 5000, size=S1)  # word (some -1)
    combo[:, 1] = rng.uniform(0.2, 8.0, size=S1).astype(np.float32).view(np.int32)
    combo[:, 2] = rng.integers(0, 5000, size=S1)  # lemma
    combo[:, 3] = rng.integers(0, S1, size=S1)  # next
    combo[:, 4] = rng.integers(0, C, size=S1)  # class
    combo[:, 8 : 8 + C_sp] = rng.integers(0, 2**30, size=(S1, C_sp))
    w_state = rng.integers(0, S1, size=(B, KW)).astype(np.int32)
    w_score = rng.uniform(0, 50, size=(B, KW)).astype(np.float32)
    w_score[rng.uniform(size=(B, KW)) < 0.1] = BIG
    emis = rng.uniform(0, 20, size=(B, C)).astype(np.float32)
    return w_state, w_score, combo, emis


def run(device) -> dict:
    """Check and time the kernel at ``SHAPE`` on a CUDA ``device``; prints
    the JSON lines and returns the numbers."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the microbench times a CUDA card, got {device}")
    w_state, w_score, combo, emis = (torch.from_numpy(x).to(device) for x in make_inputs(**SHAPE))
    args = (w_state, w_score, combo, emis, SHAPE["C_sp"])
    got, want = wordend_block(*args), wordend_block_plain(*args)
    torch.cuda.synchronize()
    correct = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    t = {}
    for variant, fn in (("plain", wordend_block_plain), ("cuda", wordend_block)):
        t[variant] = (cuda_ms(lambda: fn(*args), REPS), cuda_graph_ms(lambda: fn(*args), REPS))
    print(json.dumps({"variant": "plain_wordend", "us": t["plain"][0] * 1e3,
                      "device_us": t["plain"][1] * 1e3, **SHAPE}))
    print(json.dumps({"variant": "cuda_wordend", "us": t["cuda"][0] * 1e3,
                      "device_us": t["cuda"][1] * 1e3, "correct": correct,
                      "device_speedup_vs_plain": t["plain"][1] / t["cuda"][1]}))
    return dict(correct=correct, max_abs_err=err, ms=t["cuda"][1], plain_ms=t["plain"][1],
                eager_ms=t["cuda"][0], plain_eager_ms=t["plain"][0])


def main() -> int:
    return 0 if run(cuda_device())["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
