"""Profile the port's decoder frame loop on one CUDA card.

Builds the benchmark setup (``rasr_tpu_torch.synthetic.build_setup``) of
one decode path on the card: ``production`` (the headline network), or
one of ``synthetic.PATHS`` (``across-word``: the across-word network with
4 context groups, bigram lookahead and compact branch slots; ``4-gram``:
a 4-gram LM, trigram lookahead under survivor updates, word-scope skips
and compact slots). Scores ``BATCH`` = 64 utterances (16 on the 4-gram
path, as ``chip_smoke.py`` runs it) of 10 s of noise and decodes their
``FRAMES`` = 998 frames once to warm up (capturing the frame step's CUDA
graph), then times on the host clock (each decode ending in a
synchronize) one decode as the program runs it, replaying the graph, and
one with the eager frame step that marks its phases (:func:`marked_decode`).
Then it profiles the first ``PROFILE_FRAMES`` = 50 frames of each under
``torch.profiler``. Prints one JSON line: ``wall_ms_per_frame`` (replayed)
and ``eager_wall_ms_per_frame`` of the timed decodes; per profiled window
(``replayed``, ``eager``) wall ms per frame, kernel launches per frame
(copies and memsets left out), device ms per frame (the sum of kernel and
copy durations), the device's busy share and the kernels that take most
device time; for the eager window, per phase of the frame step
(``decoder.PHASES``) the host microseconds per step and the device
milliseconds per step; last, ``spans_us``: per program span name, the
count, mean, min, max and sum of its microseconds over the whole run
(``profiling.report()``: the decodes' ``decode.dispatch``, the graph's
``decode.capture`` and the eager window's phases).

The eager step marks the end of each phase (``decode.step.<phase>`` spans
of ``utils/profiling.py``, on the profiler's clock); a kernel or copy
counts to the phase during which the host launched it (the runtime call
that its correlation id names), and ``outside`` holds what the decode
launched outside the frame steps:

    python -m rasr_tpu_torch.examples.profile_decode [--path across-word] [--beam slice_a] \
        [--trace-dir DIR]

The profiled windows' traces go to ``--trace-dir`` (a new temporary
directory by default, named on standard error), one directory per window
(``eager``, ``replayed``): ``trace.json`` (the profiler's), ``spans.json``
(the program's spans on its time base) and ``merged.json``, both in one.
Open ``merged.json`` in https://ui.perfetto.dev (Open trace file) or
``chrome://tracing``: the phases sit on the "program spans" row over the
host's calls and the card's kernels.

The counterpart of ``examples/profile_decode.py`` (the JAX package's HLO
profile).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from ..device import cuda_device
from ..search.decoder import PHASES, _decode_block, init_carry
from ..synthetic import PATHS, PRODUCTION_BEAM, SLICE_A_BEAM, build_setup
from ..utils import profiling

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


def device_ns_by_span(prof, spans) -> dict:
    """Device ns of the kernels and copies each span's name launched: each
    device event's launch is the host runtime call its correlation id
    names, and its span the one whose interval holds that call's start
    (``outside`` where none does, ``unmatched`` where no launch is found).
    The spans are on the profiler's clock (``utils/profiling.py``)."""
    launch, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.correlation_id(), e.duration_ns()))
        elif e.name().startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    spans = sorted(spans, key=lambda sp: sp.start_ns)
    starts = [sp.start_ns for sp in spans]
    out = defaultdict(int)
    for corr, ns in dev:
        t = launch.get(corr)
        if t is None:
            out["unmatched"] += ns
            continue
        i = bisect.bisect_right(starts, t) - 1
        out[spans[i].name if i >= 0 and t <= spans[i].end_ns else "outside"] += ns
    return dict(out)


def emissions(setup, device, batch: int, frames: int) -> torch.Tensor:
    """``[batch, frames, M]`` emissions of seeded noise (10 s of it at 998
    frames), through ``setup``'s frontend and scorer on ``device``."""
    samples = (frames + 3) * 160 + 400  # 10 ms shift, 25 ms window: >= frames frames
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=(batch, samples)) * 0.1).astype(np.float32)).to(device)
    feats, _ = setup.frontend(x, torch.full((batch,), samples, device=device))
    return setup.scorer(feats)[:, :frames].contiguous()


def marked_decode(decoder, emis: torch.Tensor, n_frames: torch.Tensor):
    """The decode of ``TreeDecoder.decode_scores_device`` with a new eager
    frame step that stamps the end of each of its phases: each frame
    becomes a program span ``decode.step`` with one child span per phase,
    in ``PHASES`` order. Returns the decode's handle."""
    B, T, _ = emis.shape
    step = decoder._new_step()
    pool = decoder.cfg.word_end_limit * T if decoder.rnn is not None else 0
    carry = init_carry(B, decoder.cfg, decoder.lm, decoder.device, decoder.rnn, pool)
    step.marks = [time.perf_counter_ns()]
    carry, recs, _ = _decode_block(step, carry, emis, 0, n_frames)
    handle = decoder._finalize(carry, [recs], n_frames)
    profiling.RECORDER.add_marked("decode.step", PHASES, step.marks)
    return handle


def window(prof, wall_ms_per_frame: float, frames: int) -> dict:
    """One profiled window's numbers per frame (see the module's docstring)."""
    window_us = wall_ms_per_frame * 1e3 * frames
    on_device = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [ev for ev in on_device if not ev.name.startswith(("Memcpy", "Memset"))]
    spans = [(ev.time_range.start, ev.time_range.end) for ev in on_device]
    by_name = defaultdict(float)
    for ev in on_device:
        by_name[ev.name] += ev.time_range.elapsed_us()
    device_us = sum(by_name.values())
    return {
        "wall_ms_per_frame": wall_ms_per_frame,
        "launches_per_frame": len(kernels) / frames,
        "device_ops_per_frame": len(on_device) / frames,
        "device_ms_per_frame": device_us / 1e3 / frames,
        "busy_share": busy_us(spans) / window_us if spans else 0.0,
        "top": [{"name": k[:80], "ms_per_frame": v / 1e3 / frames, "share": v / device_us}
                for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def profile(device, beam: str, path: str = "production", trace_dir: str = "") -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the profile times a CUDA card, got {device}")
    t0 = time.perf_counter()
    s = build_setup(device=device, beam=BEAMS[beam], **PATHS.get(path, {}))
    setup_s = time.perf_counter() - t0
    B = BATCH_OF_PATH.get(path, BATCH)
    emis = emissions(s, device, B, FRAMES)
    runs = {"replayed": s.decoder.decode_scores_device, "eager":
            lambda e, n: marked_decode(s.decoder, e, n)}

    def decode(how, f):
        t0 = time.perf_counter()
        out = runs[how](emis[:, :f], torch.full((B,), f, dtype=torch.int64, device=device))
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / f

    decode("replayed", FRAMES)
    wall = {how: decode(how, FRAMES)[1] for how in runs}
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="profile_decode_")
    out = {
        "path": path, "beam": beam, "batch": B, "frames": FRAMES,
        "profile_frames": PROFILE_FRAMES, "setup_s": setup_s,
        "states": s.tree.num_states, "branch_width": s.beam.branch_width,
        "wall_ms_per_frame": wall["replayed"], "eager_wall_ms_per_frame": wall["eager"],
    }
    for how in runs:
        since = profiling.RECORDER.now_ns()
        with profiling.trace(os.path.join(trace_dir, how)) as prof:
            wall_ms = decode(how, PROFILE_FRAMES)[1]
        print(f"[profile_decode] traces in {trace_dir}; open "
              f"{profiling.merge_chrome(os.path.join(trace_dir, how))}", file=sys.stderr)
        out[how] = window(prof, wall_ms, PROFILE_FRAMES)
        if how != "eager":
            continue
        marks = {p: [sp for sp in profiling.records(f"decode.step.{p}") if sp.start_ns >= since]
                 for p in PHASES}
        steps = len(marks[PHASES[0]])
        by_phase = device_ns_by_span(prof, [sp for ps in marks.values() for sp in ps])
        out[how].update({
            "marked_steps": steps,
            "phases": {p: {"host_us_per_step": sum(sp.end_ns - sp.start_ns for sp in marks[p])
                           / 1e3 / max(steps, 1),
                           "device_ms_per_step": by_phase.get(f"decode.step.{p}", 0) / 1e6
                           / max(steps, 1)} for p in PHASES},
            "device_ms_outside_steps": by_phase.get("outside", 0) / 1e6,
            "device_ms_unmatched": by_phase.get("unmatched", 0) / 1e6,
        })
    out["spans_us"] = profiling.report()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=["production", *PATHS], default="production")
    ap.add_argument("--beam", choices=sorted(BEAMS), default="production")
    ap.add_argument("--trace-dir", default="", help="where the profiled window's traces go")
    args = ap.parse_args(argv)
    out = profile(cuda_device(), args.beam, args.path, args.trace_dir)
    if not all(out[how]["launches_per_frame"] for how in ("eager", "replayed")):
        raise RuntimeError("the profiler saw no device kernels")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
