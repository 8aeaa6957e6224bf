"""Rank side of the port's gloo-world parity tests.

    python tests/torch_parallel_ranks.py WORKDIR RANK WORLD INIT_METHOD

Imports only the port (and numpy). ``WORKDIR/cases.pkl`` lists the cases
as ``(name, function, mesh shape, kwargs)``, their inputs port objects and
numpy arrays; each rank joins the gloo world, runs every case on its
``(data, model)`` mesh and writes each output as ``name/key`` into
``WORKDIR/out_r<RANK>.npz`` (a failed case's traceback as
``name/__error__``). The test modules call :func:`run_world` and hold
each rank's outputs to the JAX package's on the same inputs.
"""

import os
import pickle
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rasr_tpu_torch.parallel import mesh as pm  # noqa: E402

HERE = os.path.abspath(__file__)


def run_world(workdir, cases, world=4, timeout=600.0):
    """Run ``cases`` on a ``world``-rank gloo world; returns ``{name: [the
    outputs of rank r, ...]}`` (raises with a case's traceback when it
    failed)."""
    workdir = str(workdir)
    with open(os.path.join(workdir, "cases.pkl"), "wb") as fh:
        pickle.dump(cases, fh)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    pm.spawn_ranks([sys.executable, HERE, workdir], world,
                   "file://" + os.path.join(workdir, "store"), timeout, env)
    outs = [dict(np.load(os.path.join(workdir, f"out_r{r}.npz"))) for r in range(world)]
    result = {}
    for name, *_ in cases:
        per_rank = []
        for r, out in enumerate(outs):
            err = out.get(f"{name}/__error__")
            if err is not None:
                raise AssertionError(f"case {name} failed on rank {r}:\n{err}")
            per_rank.append({k.split("/", 1)[1]: v for k, v in out.items()
                             if k.startswith(name + "/")})
        result[name] = per_rank
    return result


# ------------------------------------------------------------------- cases
def mesh_shapes(mesh):
    auto = pm.make_mesh(model=1, device="cpu")
    return dict(shape=np.array(mesh.shape), auto=np.array(auto.shape),
                data=pm.axis_index(mesh, "data"), model=pm.axis_index(mesh, "model"))


def sharded_gmm(mesh, mixtures, feats, **kw):
    from rasr_tpu_torch.parallel.sharded import ShardedGmmScorer

    rows = pm.data_rows(mesh, len(feats))
    return dict(scores=ShardedGmmScorer(mixtures, mesh, **kw)(feats).numpy(),
                rows=np.array([rows.start, rows.stop]))


def dp_accumulate(mesh, mixtures, feats, labels):
    from rasr_tpu_torch.parallel.sharded import dp_accumulate

    count, s1, s2 = dp_accumulate(mesh, mixtures, feats, labels)
    return dict(count=count, sum=s1, sumsq=s2)


def psum_counters(mesh, values):
    from rasr_tpu_torch.parallel.sharded import psum_counters

    return dict(total=psum_counters(mesh, pm.shard_batch(mesh, values).numpy()))


def shard_batch(mesh, x):
    local = pm.shard_batch(mesh, x)
    return dict(local=local.numpy(), device=np.array(str(local.device)),
                placements=np.array(repr(pm.data_sharding(mesh))))


def decode(mesh, tree, lm, cfg, emis, n, tables=None, bla=None, rnn=None, beam_axis=None,
           records=False):
    from rasr_tpu_torch.search.decoder import TreeDecoder, traceback as walk

    dec = TreeDecoder(tree, lm, cfg, bigram_la=bla, rnn_fusion=rnn, device="cpu", tables=tables)
    h = dec.decode_scores_device(emis, n, mesh=mesh, beam_axis=beam_axis)
    out = dict(walk=walk(h).numpy())
    if records:
        host = h.records_to_host()
        out.update({f"rec{i}": x for i, x in enumerate(host.records)})
        out.update({f"fin{i}": x for i, x in enumerate(host.finals)})
        out["n_frames"] = host.n_frames
    return out


def dp_decode(mesh, tree, lm, cfg, emis, n):
    from rasr_tpu_torch.parallel.sharded import dp_decode
    from rasr_tpu_torch.search.decoder import TreeDecoder

    res = dp_decode(TreeDecoder(tree, lm, cfg, device="cpu"), mesh, emis, n)
    return dict(orth=np.array([r.orth for r in res]), score=np.array([r.score for r in res]))


def recognizer(mesh, corpus_path, batch_size):
    """The recognizer over ``mesh`` and alone on a small synthetic setup:
    both runs' words, and the mesh run's WER counters summed over data."""
    from rasr_tpu_torch.corpus.bliss import CorpusDescription
    from rasr_tpu_torch.parallel.sharded import psum_counters
    from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
    from rasr_tpu_torch.pipeline.visitor import CorpusVisitor
    from rasr_tpu_torch.search.decoder import BeamConfig
    from rasr_tpu_torch.synthetic import build_setup

    beam = BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8, lm_scale=10.0)
    s = build_setup(num_words=30, num_phones=8, num_classes=50, densities=2, beam=beam,
                    device="cpu")
    corpus = CorpusDescription.load(corpus_path)
    runs = {}
    for label, m in (("mesh", mesh), ("alone", None)):
        rec = OfflineRecognizer(s.frontend, s.scorer, s.decoder, mesh=m)
        res = rec.run(CorpusVisitor(corpus, batch_size=batch_size))
        runs[label] = np.array([r.orth for r in res])
        runs[f"{label}_counts"] = np.array([rec.evaluator.total.errors,
                                            rec.evaluator.total.reference_length])
    runs["merged"] = psum_counters(mesh, runs["mesh_counts"][None])
    return runs


def conformer_tp(mesh, net_kw, state, x, lengths):
    from rasr_tpu_torch.models.nn import ConformerEncoderNet
    from rasr_tpu_torch.parallel.sharded import conformer_param_specs, shard_conformer_params

    net = ConformerEncoderNet(**net_kw, device="cpu")
    net.load_state_dict(state)
    specs = {k: repr(v) for k, v in conformer_param_specs(net).items()}
    shard_conformer_params(net, mesh)
    rows = pm.data_rows(mesh, len(x))
    with torch.no_grad():
        y = net(torch.as_tensor(x[rows]), lengths=torch.as_tensor(lengths[rows]))
    q = net.block[0].mhsa.query.weight
    return dict(out=y.numpy(), rows=np.array([rows.start, rows.stop]),
                specs=np.array(sorted(specs.items())),
                query_placement=np.array(repr(q.placements)),
                query_local=np.array(q.to_local().shape))


def dp_fmllr(mesh, mixtures, feats, mix):
    from rasr_tpu_torch.parallel.sharded import dp_fmllr_stats

    G, k, beta = dp_fmllr_stats(mesh, mixtures, feats, mix)
    return dict(G=G, k=k, beta=np.array(beta))


def sp_frontend(mesh, fe_kw, samples, lengths):
    from rasr_tpu_torch.ops.frontend import FeatureFrontend
    from rasr_tpu_torch.parallel.sequence import SpFrontend

    sp = SpFrontend(FeatureFrontend(**fe_kw, device="cpu"), mesh)
    try:
        chunk, n = sp(samples, lengths)
    except ValueError as e:
        return dict(error=np.array(str(e)))
    return dict(feats=sp.gather(chunk, (chunk.shape[1] * sp.P)).numpy(), chunk=chunk.numpy(),
                n=n.numpy())


def sp_viterbi(mesh, arrays):
    from rasr_tpu_torch.parallel.sequence import sp_viterbi_align

    best, states = sp_viterbi_align(mesh, *arrays)
    return dict(best=best.numpy(), states=states.numpy())


def dryrun(mesh, n):
    from rasr_tpu_torch.parallel.dryrun import dryrun_multichip

    return {k: np.asarray(v) for k, v in dryrun_multichip(n, device="cpu").items()}


def main():
    workdir = sys.argv[1]
    rank, world, init = pm.rank_args()
    torch.set_num_threads(1)
    pm.init_distributed("gloo", init, rank, world)
    meshes = {}
    with open(os.path.join(workdir, "cases.pkl"), "rb") as fh:
        cases = pickle.load(fh)
    out = {}
    for name, fn, shape, kw in cases:
        try:
            if shape not in meshes:  # built in case order: the same on every rank
                meshes[shape] = pm.make_mesh(*shape, device="cpu")
            for k, v in globals()[fn](meshes[shape], **kw).items():
                out[f"{name}/{k}"] = np.asarray(v)
        except Exception:
            out[f"{name}/__error__"] = np.array(traceback.format_exc())
    np.savez(os.path.join(workdir, f"out_r{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
