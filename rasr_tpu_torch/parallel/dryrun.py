"""A multi-rank dry run of the sharded training step.

    python -m rasr_tpu_torch.parallel.dryrun --ranks N [--backend gloo|nccl] [--device cpu]

The counterpart of the reference's ``__graft_entry__.py::dryrun_multichip``:
on a ``(data, model)`` mesh over N ranks (``model`` = 2 when N is even),
one GMM training step of a small synthetic system: emissions scored by
:class:`~.sharded.ShardedGmmScorer` (the mixture inventory over
``model``, the GMM kernel on a card), a forced alignment of each data
rank's utterances through linear graphs (``ops/viterbi.py``), and the
single-density EM statistics summed over ``data`` into new means and
variances. Every rank also runs the same step unsharded on the whole
batch, and the two must agree (the alignments' counts exactly, their
costs and the statistics within 1e-4 relative). The ranks run on the card unless
``--device cpu`` is given; the backend is named, never switched: gloo
(CPU ranks, or several ranks sharing card 0) or nccl (rank r on card r).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from ..models.gmm import MixtureSet
from ..models.scorer import GmmFeatureScorer
from ..ops.viterbi import BIG, viterbi_align
from . import mesh as pm
from .sharded import ShardedGmmScorer


def _step(scores, eids, graph, nf, feats, M):
    """Alignment of ``[B, T, M]`` scores through the linear graphs, then the
    single-density statistics ``(cost [B], count [M], s1 [M, D], s2)``."""
    emis = torch.gather(scores, 2, eids[:, None, :].expand(-1, scores.shape[1], -1))
    cost, states = viterbi_align(emis, *graph, nf)
    labels = torch.gather(eids, 1, states.clamp(min=0))
    w = (states >= 0).to(torch.float32).reshape(-1)
    onehot = torch.nn.functional.one_hot(labels.reshape(-1), M).to(torch.float32) * w[:, None]
    x = feats.reshape(-1, feats.shape[-1])
    return cost, onehot.sum(0), onehot.T @ x, onehot.T @ (x * x)


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """Run the step on every rank of an initialized process group of
    ``n_ranks``; returns the rank's (replicated) results."""
    assert torch.distributed.get_world_size() == n_ranks, (
        f"need {n_ranks} ranks, have {torch.distributed.get_world_size()}")
    model_par = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    mesh = pm.make_mesh(data=n_ranks // model_par, model=model_par, device=device)
    dev = pm.mesh_device(mesh)

    rng = np.random.default_rng(0)
    B = pm.axis_size(mesh, "data") * 2
    T, S, D = 12, 8, 8
    M, K = 16, 2  # the mixture inventory (sharded over 'model')
    ms = MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=np.ones((M, K, D), np.float32),
        weights=np.full((M, K), 0.5, np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    eids = torch.as_tensor(np.tile(np.arange(S) % M, (B, 1)), device=dev)
    loop = np.full((B, S), 1.0, np.float32)
    fwd = np.zeros((B, S), np.float32)
    fwd[:, 0] = BIG
    skip = np.full((B, S), BIG, np.float32)
    init = np.full((B, S), BIG, np.float32)
    init[:, 0] = 0
    final = np.full((B, S), BIG, np.float32)
    final[:, -1] = 0
    graph = [torch.as_tensor(a, device=dev) for a in (loop, fwd, skip, init, final)]
    n_frames = torch.full((B,), T, device=dev)
    feats = torch.as_tensor(rng.normal(size=(B, T, D)).astype(np.float32), device=dev)

    # --- sharded: TP scoring of this data rank's rows, DP alignment and
    # statistics, summed over 'data'
    rows = pm.data_rows(mesh, B)
    scores = ShardedGmmScorer(ms, mesh)(feats)
    cost, count, s1, s2 = _step(scores, eids[rows], [g[rows] for g in graph], n_frames[rows],
                                feats[rows], M)
    cost = pm.gather_rows(cost, mesh, B)
    count, s1, s2 = (pm.all_reduce(x, mesh, "data") for x in (count, s1, s2))
    means = s1 / count.clamp(min=1e-6)[:, None]
    variances = (s2 / count.clamp(min=1e-6)[:, None] - means ** 2).clamp(min=1e-4)

    # --- the same step unsharded, on the whole batch
    want = _step(GmmFeatureScorer(ms, device=dev)(feats), eids, graph, n_frames, feats, M)
    if not torch.equal(count, want[1]):
        raise AssertionError("sharded alignment differs from the unsharded one")
    for got, ref in ((cost, want[0]), (s1, want[2]), (s2, want[3])):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    if not bool(torch.isfinite(cost).all()) or not float(count.sum()) > 0:
        raise AssertionError("the training step produced no finite alignment")
    return dict(mesh=(pm.axis_size(mesh, "data"), model_par), device=str(dev),
                cost=cost.mean().item(),
                count=count.cpu().numpy(), means=means.cpu().numpy(),
                variances=variances.cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", choices=pm.BACKENDS, default="gloo")
    ap.add_argument("--device", default=None, help="'cpu', or the card (the default)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", nargs=3, help=argparse.SUPPRESS)  # set on spawned ranks
    args = ap.parse_args(argv)
    if args.rank is None:
        with tempfile.TemporaryDirectory() as tmp:
            argv = [sys.executable, "-m", "rasr_tpu_torch.parallel.dryrun",
                    "--ranks", str(args.ranks), "--backend", args.backend,
                    "--timeout", str(args.timeout)]
            if args.device:
                argv += ["--device", args.device]
            outs = pm.spawn_ranks(argv + ["--rank"], args.ranks,
                                  "file://" + os.path.join(tmp, "store"), args.timeout)
        for out in outs:
            sys.stdout.write(out)
        return 0
    rank, world, init = pm.rank_args(args.rank)
    device = args.device
    if device is None and args.backend == "nccl":
        device = f"cuda:{rank}"  # NCCL: a card per rank
    pm.init_distributed(args.backend, init, rank, world)
    try:
        res = dryrun_multichip(world, device=device)
        print(f"dryrun rank {rank}/{world} mesh {res['mesh']} ({args.backend}, "
              f"{res['device']}): mean alignment cost {res['cost']:.4f}, "
              f"{int(res['count'].sum())} frames counted; sharded == unsharded", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
