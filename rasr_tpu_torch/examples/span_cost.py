"""What the program's spans cost the decoder's host dispatch, on one CUDA card.

Builds the production decode setup (``synthetic.build_setup``) and
``profile_decode``'s batch of 64 utterances of 10 s of noise (998 frames),
decodes it once to warm up, then times on the host clock the dispatch of
each decode (the call of ``decode_scores_device``), over its frame steps:

- ``off``: ``--decodes`` whole decodes with no profiler, each followed by
  its best-path read (``results_from_device``). Where the program records
  spans, each decode's ``decode.dispatch`` span per step and its
  ``decode.read.wait`` (the host's wait for the card at the read) are
  printed beside the outside timing.
- ``on``: ``--profiled`` decodes of the first ``--profile-frames`` frames
  under ``torch.profiler``, as the program runs them there (a program
  whose frame step marks its phases under the profiler marks them; this
  one replays its CUDA graph, as off the profiler).

Prints one JSON line: per series the host microseconds per step of each
decode, their median and quartiles. It calls only what the decoder has
offered since before it recorded spans, so a copy of this file in an
older checkout times that checkout's dispatch: run the two in turns in
one process each, on one card:

    python -m rasr_tpu_torch.examples.span_cost [--decodes 12] [--profiled 8] \\
        [--profile-frames 300]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..device import cuda_device
from ..synthetic import PRODUCTION_BEAM, build_setup
from ..utils import profiling
from .profile_decode import emissions

BATCH, FRAMES = 64, 998


def _summary(values) -> dict:
    out = {"values": values}
    if len(values) >= 2:
        q1, med, q3 = statistics.quantiles(values, n=4)
        out.update(median=med, q1=q1, q3=q3)
    elif values:
        out["median"] = values[0]
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device, decodes: int = 12, profiled: int = 8, profile_frames: int = 300,
        setup=None, batch: int = BATCH, frames: int = FRAMES) -> dict:
    """The two series (see the module's docstring) on ``device``; ``setup``
    and the sizes stand in for the production setup where given."""
    device = torch.device(device)
    s = setup or build_setup(device=device, beam=PRODUCTION_BEAM)
    emis = emissions(s, device, batch, frames)
    records = getattr(profiling, "records", None)  # None: a program without spans

    def dispatch_us_per_step(f: int) -> float:
        nf = torch.full((batch,), f, dtype=torch.int64, device=device)
        _sync(device)
        t0 = time.perf_counter_ns()
        handle = s.decoder.decode_scores_device(emis[:, :f], nf)
        us = (time.perf_counter_ns() - t0) / 1e3 / f
        s.decoder.results_from_device(handle)
        return us

    dispatch_us_per_step(frames)  # warm-up
    off = {"host_us_per_step": [], "dispatch_span_us_per_step": [], "read_wait_us": []}
    for _ in range(decodes):
        off["host_us_per_step"].append(dispatch_us_per_step(frames))
        if records is not None:
            (span,), (wait,) = records("decode.dispatch")[-1:], records("decode.read.wait")[-1:]
            off["dispatch_span_us_per_step"].append(
                (span.end_ns - span.start_ns) / 1e3 / span.counts["steps"])
            off["read_wait_us"].append((wait.end_ns - wait.start_ns) / 1e3)

    on = []
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for _ in range(profiled):
        with torch.profiler.profile(activities=acts):
            on.append(dispatch_us_per_step(profile_frames))
    return {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "batch": batch, "frames": frames, "profile_frames": profile_frames,
        "off": {k: _summary(v) for k, v in off.items()},
        "on": _summary(on),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decodes", type=int, default=12)
    ap.add_argument("--profiled", type=int, default=8)
    ap.add_argument("--profile-frames", type=int, default=300)
    args = ap.parse_args(argv)
    print(json.dumps(run(cuda_device(), args.decodes, args.profiled, args.profile_frames)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
