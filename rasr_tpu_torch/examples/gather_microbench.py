"""Random row gather on one CUDA card: the kernel against its plain version.

The port's counterpart of ``examples/pallas_gather_microbench.py``: the
decoder's state-pack gather shape (65,536 random rows of a 56,432 x 16
int32 table) with the same ``default_rng(0)`` draws. Runs ``table[idx]``
and the hand-written CUDA kernel, asserts equality, times both with CUDA
events (``us``: a call as the caller pays for it, host dispatch included;
``device_us``: the same calls replayed from a CUDA graph, so device time
alone) and prints one JSON line per variant:

    python -m rasr_tpu_torch.examples.gather_microbench

Nothing catches a kernel failure: a failed build or launch raises, and a
disagreement exits non-zero.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import cuda_device, cuda_graph_ms, cuda_ms
from ..ops.kernels.row_gather import row_gather, row_gather_plain

SHAPE = dict(S=56432, C=16, N=65536)

REPS = 20  # calls per timing


def make_inputs(S, C, N, seed=0):
    """(table, idx) as numpy arrays, drawn as the JAX example draws them."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**30, size=(S, C)).astype(np.int32)
    idx = rng.integers(0, S, size=(N,)).astype(np.int32)
    return table, idx


def run(device) -> dict:
    """Check and time the kernel at ``SHAPE`` on a CUDA ``device``; prints
    the JSON lines and returns the numbers."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the microbench times a CUDA card, got {device}")
    table, idx = (torch.from_numpy(x).to(device) for x in make_inputs(**SHAPE))
    got, want = row_gather(table, idx), row_gather_plain(table, idx)
    torch.cuda.synchronize()
    correct = torch.equal(got, want)
    t = {}
    for variant, fn in (("plain", row_gather_plain), ("cuda", row_gather)):
        t[variant] = (cuda_ms(lambda: fn(table, idx), REPS),
                      cuda_graph_ms(lambda: fn(table, idx), REPS))
    N = SHAPE["N"]
    print(json.dumps({"variant": "plain_gather", "us": t["plain"][0] * 1e3,
                      "device_us": t["plain"][1] * 1e3,
                      "device_ns_per_row": t["plain"][1] * 1e6 / N, **SHAPE}))
    print(json.dumps({"variant": "cuda_gather", "us": t["cuda"][0] * 1e3,
                      "device_us": t["cuda"][1] * 1e3,
                      "device_ns_per_row": t["cuda"][1] * 1e6 / N, "correct": correct,
                      "device_speedup_vs_plain": t["plain"][1] / t["cuda"][1]}))
    return dict(correct=correct, max_abs_err=float((got - want).abs().max()),
                ms=t["cuda"][1], plain_ms=t["plain"][1], eager_ms=t["cuda"][0],
                plain_eager_ms=t["plain"][0], ns_per_row=t["cuda"][1] * 1e6 / N)


def main() -> int:
    return 0 if run(cuda_device())["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
