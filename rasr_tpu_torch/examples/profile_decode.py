"""Profile the port's decoder frame loop on one CUDA card.

Builds the benchmark setup (``rasr_tpu_torch.synthetic.build_setup``) of
one decode path on the card: ``production`` (the headline network), or
one of ``synthetic.PATHS`` (``across-word``: the across-word network with
4 context groups, bigram lookahead and compact branch slots; ``4-gram``:
a 4-gram LM, trigram lookahead under survivor updates, word-scope skips
and compact slots). Scores ``BATCH`` = 64 utterances (16 on the 4-gram
path, as ``chip_smoke.py`` runs it) of 10 s of noise, decodes their
``FRAMES`` = 998 frames once to warm up and once timed on the host clock
(ending in a synchronize), then their first ``PROFILE_FRAMES`` = 50 frames
under ``torch.profiler``. Prints one JSON line: wall ms per frame of the
timed decode, and of the profiled window kernel launches per frame
(copies and memsets left out), device ms per frame (the sum of kernel
and copy durations), the device's busy share, and the kernels that take
most device time:

    python -m rasr_tpu_torch.examples.profile_decode [--path across-word] [--beam slice_a]

The counterpart of ``examples/profile_decode.py`` (the JAX package's HLO
profile).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from ..device import cuda_device
from ..synthetic import PATHS, PRODUCTION_BEAM, SLICE_A_BEAM, build_setup

BEAMS = {"production": PRODUCTION_BEAM, "slice_a": SLICE_A_BEAM}
BATCH, FRAMES, PROFILE_FRAMES, TOP = 64, 998, 50, 12
BATCH_OF_PATH = {"4-gram": 16}


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def emissions(setup, device, batch: int, frames: int) -> torch.Tensor:
    """``[batch, frames, M]`` emissions of seeded noise (10 s of it at 998
    frames), through ``setup``'s frontend and scorer on ``device``."""
    samples = (frames + 3) * 160 + 400  # 10 ms shift, 25 ms window: >= frames frames
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=(batch, samples)) * 0.1).astype(np.float32)).to(device)
    feats, _ = setup.frontend(x, torch.full((batch,), samples, device=device))
    return setup.scorer(feats)[:, :frames].contiguous()


def profile(device, beam: str, path: str = "production") -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the profile times a CUDA card, got {device}")
    t0 = time.perf_counter()
    s = build_setup(device=device, beam=BEAMS[beam], **PATHS.get(path, {}))
    setup_s = time.perf_counter() - t0
    B = BATCH_OF_PATH.get(path, BATCH)
    emis = emissions(s, device, B, FRAMES)

    def decode(f):
        out = s.decoder.decode_scores_device(
            emis[:, :f], torch.full((B,), f, dtype=torch.int64, device=device))
        torch.cuda.synchronize()
        return out

    decode(FRAMES)
    t0 = time.perf_counter()
    decode(FRAMES)
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        decode(PROFILE_FRAMES)
        window_us = (time.perf_counter() - t0) * 1e6
    on_device = [ev for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [ev for ev in on_device if not ev.name.startswith(("Memcpy", "Memset"))]
    spans = [(ev.time_range.start, ev.time_range.end) for ev in on_device]
    by_name = defaultdict(float)
    for ev in on_device:
        by_name[ev.name] += ev.time_range.elapsed_us()
    device_us = sum(by_name.values())
    return {
        "path": path, "beam": beam, "batch": B, "frames": FRAMES,
        "profile_frames": PROFILE_FRAMES, "setup_s": setup_s,
        "states": s.tree.num_states, "branch_width": s.beam.branch_width,
        "wall_ms_per_frame": wall_ms / FRAMES,
        "profiled_wall_ms_per_frame": window_us / 1e3 / PROFILE_FRAMES,
        "launches_per_frame": len(kernels) / PROFILE_FRAMES,
        "device_ops_per_frame": len(on_device) / PROFILE_FRAMES,
        "device_ms_per_frame": device_us / 1e3 / PROFILE_FRAMES,
        "busy_share": busy_us(spans) / window_us if spans else 0.0,
        "top": [{"name": k[:80], "ms_per_frame": v / 1e3 / PROFILE_FRAMES,
                 "share": v / device_us}
                for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=["production", *PATHS], default="production")
    ap.add_argument("--beam", choices=sorted(BEAMS), default="production")
    args = ap.parse_args(argv)
    out = profile(cuda_device(), args.beam, args.path)
    if not out["launches_per_frame"]:
        raise RuntimeError("the profiler saw no device kernels")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
