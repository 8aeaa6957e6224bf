"""The port runs where there is no JAX (the situation on the card's machine).

A subprocess makes ``jax`` and the JAX package ``rasr_tpu`` unimportable,
imports every module of ``rasr_tpu_torch`` and drives a tiny decode slice
on the CPU, on the within-word tree, on the across-word network with 4
context groups, bigram lookahead and compact branch slots, and behind a
small conformer hybrid scorer; each decode is also streamed in blocks. A
second subprocess runs the offline recognizer over a synthesized corpus
with a lattice archive, a CTM file and an n-best file, and the benchmark
entry point at a tiny size. A third drives the training side: forced alignment (Viterbi
and Baum-Welch), an EM step, LDA, fMLLR and MLLR, frame and sequence CE
training with a checkpoint, LF-MMI and sMBR steps, lattice rescoring, the
recognizer with speaker transforms and the ``BENCH_TRAIN=1`` entry at a
tiny width. A fourth runs the neural LM and the second pass: RNN-LM
training, a fused decode offline and streamed, n-best lists, confusion
networks and RNN rescoring of its lattice, an MMI accumulation and the
battery. A fifth runs the other front ends and the general networks: the
MFCC frontend with all four options (energy, sliding CMVN, deltas, VTLN),
the gammatone frontend, a DSP op, a VTLN grid search, and a WFST grammar
network decoded offline and streamed under its re-entry lookahead, with
its lattice bridged to an FSA. A sixth runs the tools in-process on a
toy corpus (features, flat-start and CART training, the recognizer with a
network image, lattices and CTM, lm-util, flf-tool, doc_gen's tool list,
which it imports by string), the packed LM through the native parser and
its images, a class LM, and the profiling helper; ``jax``, ``flax``,
``optax`` and ``msgpack`` are unimportable there too. A tool started as
``python -m rasr_tpu_torch.tools.<tool>`` without a ``device`` fails where
no card is visible. The port carries its own copies of the host modules,
so it loads no module of ``rasr_tpu``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["rasr_tpu"] = None  # and so does any import of the JAX package
import numpy as np, torch
import rasr_tpu_torch
for m in pkgutil.walk_packages(rasr_tpu_torch.__path__, "rasr_tpu_torch."):
    importlib.import_module(m.name)
from rasr_tpu_torch.search.decoder import BeamConfig
from rasr_tpu_torch.search.streaming import StreamingDecoder
from rasr_tpu_torch.synthetic import PATHS, build_setup
beam = BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8, lm_scale=10.0)
x = torch.from_numpy((np.random.default_rng(0).normal(size=(2, 8000)) * 0.1)
                     .astype(np.float32))
conformer = dict(d_model=16, num_blocks=1, num_heads=2, ff_mult=2, conv_kernel=3)
for knobs in ({}, dict(PATHS["across-word"], branch_width=40),
              dict(PATHS["conformer"], conformer=conformer)):
    s = build_setup(num_words=30, num_phones=8, num_classes=50, densities=2, beam=beam,
                    device="cpu", **knobs)
    assert (s.bigram_la is not None) == ("across_word" in knobs)
    feats, n = s.frontend(x, torch.tensor([8000, 6000]))
    e = s.scorer(feats, lengths=n)
    res = s.decoder.results_from_device(s.decoder.decode_scores_device(e, n))
    assert len(res) == 2 and all(np.isfinite(r.score) and r.words for r in res), res
    sd = StreamingDecoder(s.decoder).restart(2, n)
    for lo in range(0, e.shape[1], 16):
        sd.feed(e[:, lo:lo + 16])
    assert [r.words for r in sd.finalize()] == [r.words for r in res]
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("rasr_tpu."))))
"""

def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("LOADED")]
    assert line.split()[1:] == [], line  # no module of rasr_tpu


RECOGNIZER_SCRIPT = r"""
import io, json, os, sys, tempfile
sys.modules["jax"] = None
sys.modules["rasr_tpu"] = None
import numpy as np
from rasr_tpu_torch import bench
from rasr_tpu_torch.corpus.audio import write_wav
from rasr_tpu_torch.corpus.bliss import CorpusDescription
from rasr_tpu_torch.lattice.lattice import Lattice
from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
from rasr_tpu_torch.pipeline.visitor import CorpusVisitor
from rasr_tpu_torch.search.decoder import BeamConfig
from rasr_tpu_torch.synthetic import build_setup
from rasr_tpu_torch.utils.archive import FileArchive
beam = BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8, lm_scale=10.0)
s = build_setup(num_words=30, num_phones=8, num_classes=50, densities=2, beam=beam, device="cpu")
rng = np.random.default_rng(0)
words = [l.primary_orth for l in s.lexicon.lemmata if not l.special]
tmp = tempfile.mkdtemp()
xml = ['<corpus name="c">']
for i in range(3):
    write_wav(f"{tmp}/r{i}.wav", (rng.normal(size=8000 + 2000 * i) * 0.1).astype(np.float32))
    orth = " ".join(rng.choice(words, size=2))
    xml.append(f'<recording name="r{i}" audio="{tmp}/r{i}.wav"><segment name="s">'
               f'<orth>{orth}</orth></segment></recording>')
(open(f"{tmp}/c.corpus", "w")).write("".join(xml) + "</corpus>")
rec = OfflineRecognizer(s.frontend, s.scorer, s.decoder, lattice_archive=f"{tmp}/lat",
                        ctm_file=f"{tmp}/ctm", nbest_file=f"{tmp}/nbest", nbest=3)
results = rec.run(CorpusVisitor(CorpusDescription.load(f"{tmp}/c.corpus"), batch_size=2))
assert len(results) == 3 and rec.evaluator.report()["ref_len"] == 6
top = {l.split(" ")[0]: l.split()[3:] for l in open(f"{tmp}/nbest") if l.split(" ")[1] == "0"}
assert top == {r.segment_name: r.words for r in results}, top
with FileArchive(f"{tmp}/lat", "r") as ar:
    assert sorted(ar.keys()) == sorted(r.segment_name for r in results)
    assert all(Lattice.unpack(ar.read(k)).num_nodes >= 1 for k in ar.keys())
out = io.StringIO()
bench.run(device="cpu", out=out, words=30, classes=50, batch=2, audio_s=1.0, iters=1, windows=1,
          max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8)
assert json.loads(out.getvalue())["metric"] == "torch_decode_throughput"
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("rasr_tpu."))))
"""


def test_recognizer_and_bench_run_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", RECOGNIZER_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("LOADED")]
    assert line.split()[1:] == [], line


TRAIN_SCRIPT = r"""
import io, math, sys, tempfile
sys.modules["jax"] = None
sys.modules["rasr_tpu"] = None
import numpy as np, torch
from rasr_tpu_torch import bench
from rasr_tpu_torch.align.aligner import BatchAligner, linear_segmentation
from rasr_tpu_torch.align.graph import build_linear_graph
from rasr_tpu_torch.lattice.lattice import Lattice, LatticeArc
from rasr_tpu_torch.lattice.rescore import rescore_am
from rasr_tpu_torch.models.hmm import HmmTopology
from rasr_tpu_torch.models.nn import ConformerEncoderNet, FeedForwardNet
from rasr_tpu_torch.models.scorer import GmmFeatureScorer
from rasr_tpu_torch.search.decoder import BeamConfig
from rasr_tpu_torch.synthetic import build_setup
from rasr_tpu_torch.train import em, fmllr, lda, lfmmi, mllr
from rasr_tpu_torch.train.checkpoint import CheckpointManager
from rasr_tpu_torch.train.nn_trainer import (
    FrameDataset, LfMmiSequenceTrainer, NnTrainer, SequenceTrainer, TrainConfig)
beam = BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8, lm_scale=10.0)
s = build_setup(num_words=30, num_phones=8, num_classes=50, densities=2, beam=beam, device="cpu")
topo = HmmTopology(states_per_phone=3, silence_states=1)
rng = np.random.default_rng(0)
words = [l.primary_orth for l in s.lexicon.lemmata if not l.special]
graphs = [build_linear_graph(" ".join(rng.choice(words, size=2)), s.lexicon, s.tying, topo)
          for _ in range(2)]
x = torch.from_numpy((rng.normal(size=(2, 16000)) * 0.1).astype(np.float32))
feats, n = s.frontend(x, torch.tensor([16000, 12000]))
labels = linear_segmentation(graphs, n.numpy())
acc = em.accumulate(em.GmmAccumulator.zeros(*s.mixtures.means.shape), s.mixtures, feats, labels)
model = em.estimate(acc, prev=s.mixtures)
aligner = BatchAligner(GmmFeatureScorer(model, device="cpu"))
als = aligner.align(feats, graphs, n)
assert [a.num_frames for a in als] == n.tolist()
total, gamma, ids = BatchAligner(aligner.scorer, "baum-welch").gamma(feats, graphs, n)
sc = lda.accumulate_scatter(lda.ScatterAccumulator.zeros(50, feats.shape[-1]), feats, labels)
proj, _ = lda.estimate_lda(sc, 10)
flat = feats[0, : int(n[0])]
G, k, beta = fmllr.fmllr_stats(flat, labels[0, : int(n[0])], model)
W = fmllr.estimate_fmllr(G, k, beta, min_count=10.0)
mllr.estimate_mllr(*mllr.mllr_stats(flat, labels[0, : int(n[0])], model), model, min_count=10.0)
ds = FrameDataset(feats.numpy(), labels)
ff = FeedForwardNet(50, feats.shape[-1], hidden=(16,), device="cpu")
tmp = tempfile.mkdtemp()
NnTrainer(ff, 50, TrainConfig(batch_size=32)).train(ds, ckpt=CheckpointManager(tmp), ckpt_every=2)
conf = ConformerEncoderNet(50, feats.shape[-1], d_model=8, num_blocks=1, num_heads=2,
                           ff_mult=2, conv_kernel=3, device="cpu")
SequenceTrainer(conf, 50, TrainConfig()).train_sequences(feats.numpy(), labels, batch_size=2)
den = lfmmi.build_phone_bigram_den(8, 3, lambda p, q: 1 + (7 * p + q) % 49,
                                   np.full((8, 8), math.log(8), np.float32), device="cpu")
for crit in ("mmi", "smbr"):
    _, st = LfMmiSequenceTrainer(conf, 50, den, criterion=crit).train_lfmmi(
        feats.numpy(), graphs, n.numpy(), labels=labels, batch_size=2)
    assert np.isfinite(st[0]["loss"]), st
orths = [l.primary_orth for l in s.lexicon.lemmata]
lat = Lattice(num_nodes=2, arcs=[LatticeArc(0, 1, orths.index(words[0]), 0.0, 0.0)],
              node_time=np.array([0, 40], np.int32), final_scores={1: 0.0}, lemma_orths=orths)
rescore_am(lat, aligner.scorer(feats)[0], s.lexicon, s.tying, topo)
from rasr_tpu_torch.pipeline.recognizer import OfflineRecognizer
assert OfflineRecognizer(s.frontend, s.scorer, s.decoder, feature_transforms={"*": W})
out = io.StringIO()
bench.run(device="cpu", out=out, train=True, train_dmodel=8, train_blocks=1, train_batch=2,
          train_frames=6, train_steps=1, classes=10)
assert "torch_train_mfu" in out.getvalue()
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("rasr_tpu."))))
"""


def test_training_side_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", TRAIN_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("LOADED")]
    assert line.split()[1:] == [], line


RNN_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["rasr_tpu"] = None
import numpy as np, torch
from rasr_tpu_torch.align.aligner import BatchAligner
from rasr_tpu_torch.lattice import flf
from rasr_tpu_torch.lattice.lattice import decoder_lattice
from rasr_tpu_torch.models.hmm import HmmTopology, TransitionModel
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.models.lm.rnn import RnnLm
from rasr_tpu_torch.pipeline.battery import build_battery_task, run_operating_point
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu_torch.search.rnn_fusion import build_rnn_fusion
from rasr_tpu_torch.search.streaming import StreamingDecoder
from rasr_tpu_torch.synthetic import build_setup
from rasr_tpu_torch.train import discriminative
beam = BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8, lm_scale=10.0)
s = build_setup(num_words=30, num_phones=8, num_classes=50, densities=2, beam=beam, device="cpu")
rng = np.random.default_rng(0)
words = [l.primary_orth for l in s.lexicon.lemmata if not l.special]
rnn = RnnLm.train_from_text([list(rng.choice(words[:-3], size=5)) for _ in range(50)],
                            embed_dim=8, hidden_dim=8, epochs=3, device="cpu")
assert rnn.train_losses[-1] < rnn.train_losses[0]
fusion = build_rnn_fusion(rnn, s.lm.vocab, weight=0.5, device="cpu")
dec = TreeDecoder(s.tree, compile_ngram(s.lm), s.beam, rnn_fusion=fusion, device="cpu",
                  tables=s.decoder.tables)
x = torch.from_numpy((rng.normal(size=(2, 8000)) * 0.1).astype(np.float32))
feats, n = s.frontend(x, torch.tensor([8000, 6000]))
e = s.scorer(feats)
handle = dec.decode_scores_device(e, n)
res = dec.results_from_device(handle)
assert all(np.isfinite(r.score) and r.words for r in res), res
sd = StreamingDecoder(dec).restart(2, n)
for lo in range(0, e.shape[1], 16):
    sd.feed(e[:, lo:lo + 16])
    assert sd._carry.cs.shape[1] == 2 * 32 + 8 * min(16, e.shape[1] - lo)
assert [r.words for r in sd.finalize()] == [r.words for r in res]
lat = decoder_lattice(handle, dec.tree.lemmas, 0)
assert flf.n_best(lat, 3) and flf.confusion_network(lat)
synt = {i: rnn.vocab.get(o) for i, o in enumerate(lat.lemma_orths)}
assert flf.best_path(flf.rescore_lm(lat, rnn, synt))[1]
topo = HmmTopology(states_per_phone=3, silence_states=1)
acc = discriminative.MmiAccumulators.zeros(*s.mixtures.means.shape)
discriminative.accumulate_denominator_from_lattice(
    acc, s.mixtures, feats[0, : int(n[0])].numpy(), lat, BatchAligner(s.scorer), s.lexicon,
    s.tying, topo, TransitionModel())
assert discriminative.ebw_update(s.mixtures, acc).means.shape == s.mixtures.means.shape
task = build_battery_task(num_words=20, num_phones=6, num_utts=2, n_train_sentences=40,
                          lookahead_classes=4, device="cpu")
assert 0.0 <= run_operating_point(task, BeamConfig(max_hyps=16, word_end_limit=4),
                                  device="cpu")["wer"]
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("rasr_tpu."))))
"""


def test_rnn_fusion_and_second_pass_run_without_jax():
    """The neural LM and the second pass with no JAX: RNN-LM training, a
    fused decode (offline and streamed, the pool at 2K + R x Tb rows),
    n-best lists, confusion networks and RNN rescoring of its lattice, an
    MMI denominator accumulation with an EBW update, and the battery."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", RNN_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("LOADED")]
    assert line.split()[1:] == [], line


FRONTEND_WFST_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["rasr_tpu"] = None
import numpy as np, torch
from rasr_tpu_torch.align.aligner import BatchAligner
from rasr_tpu_torch.align.graph import build_linear_graph
from rasr_tpu_torch.fsa.algorithms import best, determinize, minimize, remove_epsilon
from rasr_tpu_torch.fsa.automaton import Automaton
from rasr_tpu_torch.lattice.lattice import decoder_lattice, lattice_to_fsa
from rasr_tpu_torch.models.hmm import HmmTopology
from rasr_tpu_torch.models.lm.grammar import FsaGrammarLm
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.ops.dsp import frame_energy
from rasr_tpu_torch.ops.frontend import FeatureFrontend, FrontendConfig
from rasr_tpu_torch.ops.gammatone import GammatoneConfig, GammatoneFrontend, piecewise_linear_warp
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu_torch.search.lookahead import build_bigram_lookahead
from rasr_tpu_torch.search.streaming import StreamingDecoder
from rasr_tpu_torch.search.wfst import compile_wfst
from rasr_tpu_torch.synthetic import build_setup
from rasr_tpu_torch.train.vtln import estimate_warping_factor
rng = np.random.default_rng(0)
x = torch.from_numpy((rng.normal(size=(2, 8000)) * 0.1).astype(np.float32))
lengths = torch.tensor([8000, 5000])
cfg = FrontendConfig(append_energy=True, normalize="sliding", norm_window=30)
fe = FeatureFrontend(cfg, delta_order=2, vtln_warp=piecewise_linear_warp(cfg.num_bins, 0.92),
                     device="cpu")
f, n = fe(x, lengths)
assert f.shape == (2, 48, 51) and bool(torch.isfinite(f).all()), f.shape
g, gn = GammatoneFrontend(GammatoneConfig(num_channels=8, num_outputs=4), device="cpu")(x, lengths)
assert g.shape == (2, 48, 4) and gn.tolist() == n.tolist()
assert frame_energy(x.reshape(2, 40, 200)).shape == (2, 40)
beam = BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8, lm_scale=10.0)
s = build_setup(num_words=30, num_phones=8, num_classes=50, densities=2, beam=beam, device="cpu")
topo = HmmTopology(states_per_phone=3, silence_states=1)
words = [l.primary_orth for l in s.lexicon.lemmata if not l.special]
graphs = [build_linear_graph(words[i], s.lexicon, s.tying, topo) for i in range(2)]
best_alpha, scores = estimate_warping_factor(
    x, lengths, graphs, BatchAligner(s.scorer), FrontendConfig(), alphas=(0.92, 1.0),
    frontend_kwargs=dict(splice_context=4, lda=s.frontend.lda.numpy()), device="cpu")
assert best_alpha in scores and all(np.isfinite(list(scores.values())))
# a command grammar over 4 words: grammar acceptor -> determinize / minimize
# -> a word loop with each word's emission class; decoded under its lookahead
grammar = FsaGrammarLm.from_sequences([w.split() for w in (
    "w0 w1", "w0 w2 w3", "w1 w3", "w2 w2 w1")])
det = minimize(determinize(remove_epsilon(grammar.fsa)))
ids = {v: k for k, v in grammar.vocab.items()}
wfst = Automaton()
for _ in range(det.num_states):
    wfst.add_state()
wfst.initial = det.initial
for st in range(det.num_states):
    for a in det.arcs[st]:
        w = int(ids[a.ilabel][1:])
        wfst.add_arc(st, a.target, w + 1, w + 1, a.weight)
for st, c in det.finals.items():
    wfst.set_final(st, c)
lm_words = {w: s.lm.vocab[words[w]] for w in range(4)}
tree = compile_wfst(wfst, 50, [s.lexicon.lemmata[1 + w] for w in range(4)], 0.3, lm_words)
la = build_bigram_lookahead(tree, s.lm, num_classes=6)
assert la.reentry
dec = TreeDecoder(tree, compile_ngram(s.lm), BeamConfig(max_hyps=64, word_end_limit=16),
                  bigram_la=la, device="cpu")
e = torch.from_numpy(rng.uniform(0, 4, size=(2, 12, 50)).astype(np.float32))
handle = dec.decode_scores_device(e, torch.tensor([12, 9]))
res = dec.results_from_device(handle)
assert all(r.words for r in res), res
sd = StreamingDecoder(dec).restart(2, torch.tensor([12, 9]))
for lo in range(0, 12, 5):
    sd.feed(e[:, lo:lo + 5])
assert [r.words for r in sd.finalize()] == [r.words for r in res]
cost, _ = best(lattice_to_fsa(decoder_lattice(handle, tree.lemmas, 0)))
assert abs(cost - res[0].score) <= 1e-3 * abs(res[0].score), (cost, res[0].score)
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("rasr_tpu."))))
"""


def test_frontends_and_wfst_decode_run_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", FRONTEND_WFST_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("LOADED")]
    assert line.split()[1:] == [], line


TOOLS_SCRIPT = r"""
import contextlib, io, os, sys, tempfile
for name in ("jax", "flax", "optax", "msgpack", "rasr_tpu"):
    sys.modules[name] = None
from pathlib import Path
import numpy as np, torch
from tests.tools_parity import toy_corpus
from rasr_tpu_torch.models.lm.arpa import NgramLm
from rasr_tpu_torch.models.lm.classlm import ClassLm
from rasr_tpu_torch.models.lm.ngram import load_tables, save_tables, score_batch
from rasr_tpu_torch.models.lm.packed import PackedNgramLm, compile_packed
from rasr_tpu_torch.pipeline.model_combination import ModelCombination
from rasr_tpu_torch.tools import (acoustic_model_trainer, doc_gen, feature_extraction, flf_tool,
                                  lm_util, speech_recognizer)
from rasr_tpu_torch.utils import native, profiling
tmp = Path(tempfile.mkdtemp())
toy_corpus(tmp)
os.chdir(tmp)
def run(tool, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert tool.main([*args, "--*.device=cpu"]) == 0, tool
    return out.getvalue()
amt = ["--acoustic-model-trainer.corpus-file=toy.corpus",
       "--acoustic-model-trainer.lexicon-file=lexicon.xml",
       "--acoustic-model-trainer.states-per-phone=1",
       "--acoustic-model-trainer.frontend.normalize=none"]
run(feature_extraction.FeatureExtractionTool, "--feature-extraction.corpus-file=toy.corpus",
    "--feature-extraction.frontend.normalize=none")
run(acoustic_model_trainer.AcousticModelTrainerTool, *amt, "--acoustic-model-trainer.iterations=3",
    "--acoustic-model-trainer.new-mixture-file=mono.mix")
run(acoustic_model_trainer.AcousticModelTrainerTool, *amt,
    "--acoustic-model-trainer.action=estimate-cart", "--acoustic-model-trainer.mixture-file=mono.mix",
    "--acoustic-model-trainer.cart-max-leaves=4")
run(acoustic_model_trainer.AcousticModelTrainerTool, *amt, "--acoustic-model-trainer.iterations=3",
    "--acoustic-model-trainer.cart-file=cart.json", "--acoustic-model-trainer.new-mixture-file=tri.mix")
sr = ["--speech-recognizer.corpus-file=toy.corpus", "--speech-recognizer.lexicon-file=lexicon.xml",
      "--speech-recognizer.lm-file=lm.arpa", "--speech-recognizer.mixture-file=tri.mix",
      "--speech-recognizer.cart-file=cart.json", "--speech-recognizer.states-per-phone=1",
      "--speech-recognizer.search.lm-scale=2.0", "--speech-recognizer.search.max-hyps=128",
      "--speech-recognizer.frontend.normalize=none", "--speech-recognizer.network-cache=net",
      "--speech-recognizer.lattice-archive=lat", "--speech-recognizer.ctm-file=ctm"]
first = run(speech_recognizer.SpeechRecognizerTool, *sr)
assert "WER: 0.0000" in first and run(speech_recognizer.SpeechRecognizerTool, *sr) == first
assert Path("net.lm.npz").exists() and len(Path("ctm").read_text().splitlines()) == 16
assert '"order": 2' in run(lm_util.LmUtilTool, "--lm-util.lm-file=lm.arpa")
assert "WER: 0.0000" in run(flf_tool.FlfTool, "--flf-tool.lattice-archive=lat",
                            "--flf-tool.corpus-file=toy.corpus", "--flf-tool.ops=best evaluate")
assert len(list(doc_gen.tool_classes())) == len(doc_gen.TOOLS)
assert native.load_native() is not None, native.build_error
packed = PackedNgramLm.from_arpa("lm.arpa")
assert Path("lm.arpa.lmbin").exists()
tables = compile_packed(packed)
save_tables(tables, "packed.npz")
cost, _ = score_batch(load_tables("packed.npz"), torch.tensor([0]), torch.tensor([packed.vocab["AB"]]))
assert torch.isfinite(cost).all()
w2c = {"AB": "C0", "BA": "C0"}
clm = ClassLm(NgramLm.train_from_text([["C0", "C0"], ["<unk>"]], order=2), packed.vocab, w2c)
assert clm.compile_to_device().table_size > 0
assert ModelCombination.__dataclass_fields__["lm_scale"]
out, rows = profiling.profile_call(lambda x: x * 2, torch.ones(4), log_dir=str(tmp / "prof"))
assert isinstance(profiling.top_table(rows), str)
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("rasr_tpu."))))
"""


def test_tools_and_the_lm_path_run_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", TOOLS_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("LOADED")]
    assert line.split()[1:] == [], line


def test_tool_without_a_device_fails_without_a_card(tmp_path):
    """``python -m rasr_tpu_torch.tools.<tool>`` left without ``device``
    computes on the card; where none is visible it fails, writing nothing,
    instead of running on the CPU."""
    (tmp_path / "c.corpus").write_text('<corpus name="c"></corpus>')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "rasr_tpu_torch.tools.feature_extraction",
         "--feature-extraction.corpus-file=c.corpus", "--feature-extraction.cache=f.cache"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device visible" in proc.stderr
    assert not (tmp_path / "f.cache").exists()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _string_imports(path):
    """The module names that ``importlib.import_module`` / ``__import__``
    calls take as string literals (an f-string's literal start)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__"):
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


FORBIDDEN = ("jax", "flax", "optax", "msgpack", "rasr_tpu")


def test_no_source_imports_jax():
    files = sorted((REPO / "rasr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for new in ("ops/dsp.py", "ops/gammatone.py", "train/vtln.py", "fsa/automaton.py",
                "fsa/algorithms.py", "models/lm/grammar.py", "search/wfst.py",
                "utils/config.py", "utils/component.py", "utils/native.py", "utils/profiling.py",
                "models/lm/packed.py", "models/lm/classlm.py", "models/cart.py",
                "pipeline/model_combination.py", "tools/application.py",
                "tools/feature_extraction.py", "tools/speech_recognizer.py",
                "tools/acoustic_model_trainer.py", "tools/nn_trainer.py", "tools/lm_util.py",
                "tools/flf_tool.py", "tools/lattice_processor.py", "tools/corpus_statistics.py",
                "tools/archiver.py", "tools/fsa_tool.py", "tools/log_analysis.py",
                "tools/doc_gen.py", "examples/toy_recipe.py"):
        assert REPO / "rasr_tpu_torch" / new in files, new
    strings = 0
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
        for name in _string_imports(path):
            strings += 1
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    assert strings >= 1  # doc_gen's tool modules
