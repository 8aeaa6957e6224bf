"""Worker processes of ``tests/test_torch_multiprocess.py`` (port only).

    python tests/torch_multiprocess_worker.py em WORKDIR RANK WORLD INIT_METHOD
    python tests/torch_multiprocess_worker.py recog WORKDIR TAG RANK WORLD INIT_METHOD
    python tests/torch_multiprocess_worker.py recog WORKDIR TAG

``em``: the DP-EM statistics and a counter sum over a ``(WORLD, 1)`` gloo
mesh, written to ``WORKDIR/em_r<RANK>.npz``. ``recog``: the toy
recognition of ``tests/test_multiprocess.py`` over the corpus partition
of this process (``CorpusWorkQueue``: the process group's rank, or one
process when no group is given), each finished segment persisted to
``WORKDIR/done.<TAG>.p<RANK>.cache``; with a group the WER counters sum
over it. ``CRASH_AFTER_BATCHES=k`` kills the process (exit 17) after k
batches. Prints ``REC-OK <rank> processed=.. skipped=.. err=.. ref=..``.
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rasr_tpu_torch.parallel import mesh as pm  # noqa: E402


def em(workdir, rank, world, init):
    from rasr_tpu_torch.models.gmm import MixtureSet
    from rasr_tpu_torch.parallel.sharded import dp_accumulate, psum_counters

    pm.init_distributed("gloo", init, rank, world)
    mesh = pm.make_mesh(world, 1, device="cpu")
    rng = np.random.default_rng(0)  # the same global batch in every process
    M, K, D, N = 4, 2, 6, 64
    model = MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 0.5, np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    feats = rng.normal(size=(N, D)).astype(np.float32)
    labels = rng.integers(0, M, size=N).astype(np.int32)
    count, s1, s2 = dp_accumulate(mesh, model, feats, labels)
    wer = psum_counters(mesh, np.array([[3.0, 100.0]]))
    np.savez(os.path.join(workdir, f"em_r{rank}.npz"), count=count, sum=s1, sumsq=s2, wer=wer)
    torch.distributed.destroy_process_group()


def recog(workdir, tag, rank=None, world=None, init=None):
    from rasr_tpu_torch.corpus.bliss import CorpusDescription
    from rasr_tpu_torch.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu_torch.lattice.evaluator import align_tokens
    from rasr_tpu_torch.models.gmm import MixtureSet
    from rasr_tpu_torch.models.hmm import HmmTopology, Tdp, TransitionModel
    from rasr_tpu_torch.models.lm.arpa import NgramLm
    from rasr_tpu_torch.models.lm.ngram import compile_ngram
    from rasr_tpu_torch.models.scorer import GmmFeatureScorer
    from rasr_tpu_torch.models.tying import MonophoneStateTying
    from rasr_tpu_torch.parallel.sharded import psum_counters
    from rasr_tpu_torch.parallel.workqueue import CorpusWorkQueue
    from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu_torch.search.tree import build_prefix_tree
    from rasr_tpu_torch.utils.archive import FileArchive

    if init is not None:
        pm.init_distributed("gloo", init, rank, world)
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    lm = NgramLm.train_from_text([["AB", "BA"], ["BA", "AB"]], order=2)
    trans = TransitionModel(
        speech=Tdp(loop=1.0, forward=0.0, skip=math.inf, exit=0.5),
        silence=Tdp(loop=0.2, forward=0.5, skip=math.inf, exit=0.3),
    )
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    M = tying.num_classes
    ms = MixtureSet(means=np.eye(M, dtype=np.float32)[:, None, :] * 4.0,
                    variances=np.ones((M, 1, M), np.float32),
                    weights=np.ones((M, 1), np.float32), num_densities=np.ones(M, np.int32))
    scorer = GmmFeatureScorer(ms, scale=1.0, device="cpu")
    dec = TreeDecoder(tree, compile_ngram(lm), BeamConfig(max_hyps=64, word_end_limit=16,
                                                          lm_scale=0.5), device="cpu")
    corpus = CorpusDescription.load(os.path.join(workdir, "toy.corpus"))
    featz = np.load(os.path.join(workdir, "feats.npz"))
    wq = CorpusWorkQueue(corpus, done_archive=None)
    done_path = os.path.join(workdir, f"done.{tag}.p{wq.process_index}.cache")
    wq.done_archive = done_path
    stats = {"err": 0.0, "ref": 0.0}
    crash_after = int(os.environ.get("CRASH_AFTER_BATCHES", "0"))
    batches = [0]

    def process_fn(batch):
        fl = [featz[s.full_name] for s in batch]
        T = max(f.shape[0] for f in fl)
        feats = np.zeros((len(fl), T, M), np.float32)
        nf = np.zeros(len(fl), np.int32)
        for i, f in enumerate(fl):
            feats[i, : f.shape[0]] = f
            nf[i] = f.shape[0]
        results = dec.decode_scores(scorer(feats), nf, names=[s.full_name for s in batch])
        with FileArchive(done_path, "a") as ar:
            for s, r in zip(batch, results):
                st, _ = align_tokens(s.orth.split(), r.words)
                stats["err"] += st.errors
                stats["ref"] += st.reference_length
                ar.write(s.full_name, r.orth.encode())
        batches[0] += 1
        if crash_after and batches[0] >= crash_after:
            print(f"CRASHING after {batches[0]} batches", flush=True)
            os._exit(17)  # a simulated death mid-run
        return [s.full_name for s in batch]

    rep = wq.run(process_fn, batch_size=2)
    err, ref = stats["err"], stats["ref"]
    if init is not None:
        err, ref = psum_counters(pm.make_mesh(world, 1, device="cpu"), np.array([[err, ref]]))
        torch.distributed.destroy_process_group()
    print(f"REC-OK {wq.process_index} processed={rep.processed} skipped={rep.skipped} "
          f"err={err:.0f} ref={ref:.0f}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, workdir, *rest = sys.argv[1:]
    if mode == "em":
        em(workdir, *pm.rank_args(rest))
    elif len(rest) == 4:
        recog(workdir, rest[0], *pm.rank_args(rest))
    else:
        recog(workdir, rest[0])
