"""Data-parallel batch decoding: one process a card, each decoding its
share of every global batch, the handles assembled over the ranks.

The job starts ``ranks`` processes of this module
(``parallel.mesh.spawn_ranks``; NCCL on cards, gloo on the CPU), one
card each. Every rank builds the configuration's system from the seed,
takes its ``data_rows`` of each global batch of ``batch`` utterances
(cut to the share's longest) and drives the port's data-parallel decode
as ``jobs/decode.py`` drives the single-card one: ``FeatureFrontend``,
the scorer, ``TreeDecoder.decode_shard_device`` (which all-reduces the
longest share's frames and assembles every rank's handle into the whole
batch's) and ``results_from_device``, with batches dispatched two deep.
The ranks agree after each batch, over a gloo group on the host, whether
the window is over. The window runs from the ranks' common start to the
last rank's last read; its rate is the real audio of every global batch
read, over it. ``setup_s`` runs to the last rank's warm-up.

After the window the job's own process holds a seeded sample to the
plain reference with ``jobs/decode.py::check`` and the configuration's
decode limits: the features and emissions of the sampled rows come from
the ranks that computed them, the words and scores from rank 0's
assembled handle of the whole batch. A traced run profiles one more
batch on rank 0. The per-layer inputs are rank 0's card's, under
``jobs/decode.py``'s names: the window ``decode`` with the work of rank
0's rows of every batch, and the traced batch's ``work`` of those rows
and ``steps`` (the frames all-reduced over the ranks).

Each rank draws the whole global batch on its card and keeps its rows, so
that every rank count reads the same utterances; the draw is in the
window.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from .. import spec, system, trace, traffic
from ..counts import Work
from ..counts import frontend as frontend_counts
from ..reference import frontend as rfe
from .decode import SPANS, WARMUP_INDEX, check


def run(r) -> dict:
    """One run of a data-parallel decode cell."""
    from rasr_tpu_torch.parallel.mesh import spawn_ranks

    world = r.traffic["ranks"]
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        (work / "run.json").write_text(json.dumps({
            "cfg": r.cfg, "traffic": r.traffic, "seed": r.seed, "seconds": r.seconds,
            "trace": r.trace, "device": r.device.type}))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(spec.ROOT), os.environ.get("PYTHONPATH")) if p))
        outs = spawn_ranks([sys.executable, "-m", "benchmark.jobs.decode_dp", str(work)], world,
                           (work / "store").as_uri(), timeout=900.0 + 2.0 * r.seconds, env=env)
        for k, text in enumerate(outs):
            print(f"--- rank {k}:\n{text[-3000:]}", file=sys.stderr)
        got = []
        for k in range(world):
            with open(work / f"rank{k}.pkl", "rb") as fh:  # written by this job's ranks
                got.append(pickle.load(fh))
    first = got[0]
    setup_s = max(g["warm_end"] for g in got) - r.started
    window_s = max(g["end"] for g in got) - min(g["start"] for g in got)
    audio_s = float(sum(n.sum() for n in first["samples"])) / r.cfg["sample_rate"]
    utts = sum(len(n) for n in first["samples"])
    print(f"[decode_dp] {world} ranks, {len(first['samples'])} batches, {utts} utterances, "
          f"{audio_s:.1f} audio-s in {window_s:.2f} s: {audio_s / window_s:.2f} audio-s/s; "
          f"set-up {setup_s:.2f} s; windows {[round(g['end'] - g['start'], 2) for g in got]} s",
          file=sys.stderr)
    out = {"end_to_end": {"audio_s_per_s": audio_s / window_s, "setup_s": setup_s},
           "attempted": utts, "memory_peak_bytes": max(g["peak"] for g in got)}
    # rank 0's card: its rows of every batch over the window, and of the traced batch
    am, rows = spec.model(r.cfg), slice(*first["rows"])
    window_work = Work()
    for n, fr in zip(first["samples"], first["frames"]):
        window_work = (window_work + frontend_counts.work(n[rows], fr[rows], r.cfg)
                       + am.forward_work(fr[rows], r.cfg))
    layer = {"window": {"decode": (window_work, window_s)}}
    if r.trace:
        n = first["traced"]
        fr = [rfe.num_frames(int(v), r.cfg) for v in n]
        layer.update(summary=first["summary"], collectives=first["collectives"],
                     work={"frontend": frontend_counts.work(n[rows], fr[rows], r.cfg),
                           "scorer": am.forward_work(fr[rows], r.cfg)},
                     steps={"decoder": max(fr)})  # the frames all-reduced over the ranks
    out["layer"] = layer

    kept = {}
    for g in got:
        kept.update({k: tuple(v.to(r.device) for v in vals) for k, vals in g["kept"].items()})
    d = system.draw(r.cfg, r.seed)
    weights = spec.model(r.cfg).weights(r.cfg, r.seed, r.device)
    out.update(check(r, d, weights, kept, first["longest"], first["results"], first["frames"]))
    return out


def _slim(res):
    """What the check reads of a ``DecodeResult``, without the lexicon."""
    return types.SimpleNamespace(
        score=res.score, word_ends=list(res.word_ends),
        lemmas=[types.SimpleNamespace(primary_orth=lem.primary_orth) for lem in res.lemmas])


def collective_seconds(prof) -> float:
    """Device seconds of the NCCL kernels in a profiled recording."""
    total = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and "nccl" in e.name().lower():
            total += e.duration_ns()
    return total * 1e-9


def rank_run(work: Path, rank: int, world: int, init: str) -> dict:
    """One rank's set-up, window and traced batch."""
    import torch.distributed as dist

    from rasr_tpu_torch.parallel import mesh as pmesh

    a = json.loads((work / "run.json").read_text())
    cfg, t, seed = a["cfg"], a["traffic"], a["seed"]
    if a["device"] == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    torch.set_num_threads(1)
    pmesh.init_distributed("nccl" if dev.type == "cuda" else "gloo", init, rank, world)
    mesh = pmesh.make_mesh(data=world, device=dev)
    host = dist.new_group(backend="gloo")  # the ranks' agreement on the window's end
    sr, B = cfg["sample_rate"], t["batch"]
    rows = pmesh.data_rows(mesh, B)
    d = system.draw(cfg, seed)
    s = system.build(cfg, d, dev, spec.model(cfg).weights(cfg, seed, dev))

    def share(index, spec_t=t):
        x, lengths, n = traffic.audio_batch(spec_t, sr, seed, index, dev)
        return x[rows, : int(n[rows].max())], lengths[rows], n

    def dispatch(x, lengths):
        with trace.span("frontend"):
            feats, nf = s.frontend(x, lengths)
        with trace.span("scorer"):
            em = s.scorer(feats, lengths=nf)
        with trace.span("decoder"):
            handle = s.decoder.decode_shard_device(em, nf, mesh, B)
        return feats, em, handle

    def read(handle):
        with trace.span("results"):
            return s.decoder.results_from_device(handle)

    # warm-up: a short batch through every stage and both collectives, then
    # the first batch's shapes through the frontend and the scorer
    warm = dict(t, min_s=t["warmup_s"], max_s=t["warmup_s"])
    read(dispatch(*share(WARMUP_INDEX, warm)[:2])[2])
    x, lengths, _ = share(0)
    feats, nf = s.frontend(x, lengths)
    s.scorer(feats, lengths=nf)
    del x, lengths, feats, nf
    trace.sync()
    warm_end = time.time()

    pick_rng = np.random.default_rng(traffic.sub_seed(seed, 4))
    kept, results, picked, frames, samples, longest = {}, {}, {}, [], [], None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dist.barrier(group=host)
    start = time.time()
    prev, i = None, 0
    while True:
        x, lengths, n = share(i)
        feats, em, handle = dispatch(x, lengths)
        top = int(np.argmax(n))
        picked[i] = [top] + [int(v) for v in pick_rng.choice(
            np.delete(np.arange(B), top), t["sample_per_batch"] - 1, replace=False)]
        for row in picked[i]:
            if rows.start <= row < rows.stop:
                j = row - rows.start
                kept[(i, row)] = (x[j, : n[row]].clone(), feats[j].clone(), em[j].clone())
        longest = longest or (i, top)
        if prev is not None:
            res = read(prev[1])
            results[prev[0]] = {row: _slim(res[row]) for row in picked[prev[0]]}
        prev = (i, handle)
        samples.append(n)
        frames.append([rfe.num_frames(int(v), cfg) for v in n])
        i += 1
        el = time.time() - start
        done = torch.tensor([int(el + el / i >= a["seconds"])])
        dist.all_reduce(done, op=dist.ReduceOp.MAX, group=host)
        if done.item():
            break
    res = read(prev[1])
    results[prev[0]] = {row: _slim(res[row]) for row in picked[prev[0]]}
    end = time.time()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del x, lengths, feats, em, handle, prev

    out = {"warm_end": warm_end, "start": start, "end": end, "peak": peak,
           "kept": {k: tuple(v.cpu() for v in vals) for k, vals in kept.items()}}
    if a["trace"]:
        x, lengths, n = share(i)
        if rank == 0:
            with trace.profiled() as prof:
                read(dispatch(x, lengths)[2])
            out["summary"] = trace.summarize(prof, SPANS)
            out["collectives"] = {"device_s": collective_seconds(prof), "batches": 1}
            out["traced"] = n
        else:
            read(dispatch(x, lengths)[2])
    if rank == 0:
        out.update(results=results, frames=frames, samples=samples, longest=longest,
                   rows=(rows.start, rows.stop))
    dist.barrier(group=host)
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    from rasr_tpu_torch.parallel.mesh import rank_args

    work_dir = Path(sys.argv[1])
    k, n_ranks, init_method = rank_args()
    got = rank_run(work_dir, k, n_ranks, init_method)
    with open(work_dir / f"rank{k}.pkl", "wb") as fh:
        pickle.dump(got, fh)
