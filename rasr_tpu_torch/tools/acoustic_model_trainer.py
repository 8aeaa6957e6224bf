"""acoustic-model-trainer tool (ref: src/Tools/AcousticModelTrainer/).

Action dispatch over the corpus, mirroring the reference's actions:

* ``action=align``: forced alignment of the corpus into an alignment cache
* ``action=accumulate``: EM statistics from feature+alignment caches
  into an accumulator file (mergeable across jobs)
* ``action=combine``: merge accumulator files
* ``action=estimate``: estimate a new mixture set from an accumulator
* ``action=split``: split densities (mixture growing)
* ``action=estimate-lda``: scatter accumulation + LDA estimation
* ``action=train``: the full align->accumulate->estimate iteration loop
  (flat start via linear segmentation)

Every action computes on the tool's ``device`` (the card unless the
configuration names another): features stay there from the frontend
through scoring, alignment and the statistics; the estimates and the CART
growing are host numpy, as in the reference.
"""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

from ..align.aligner import BatchAligner, linear_segmentation
from ..align.graph import build_linear_graph
from ..corpus.bliss import CorpusDescription
from ..corpus.lexicon import Lexicon
from ..models.gmm import MixtureSet
from ..models.hmm import HmmTopology, TransitionModel
from ..models.scorer import GmmFeatureScorer
from ..models.tying import MonophoneStateTying
from ..pipeline.visitor import CorpusVisitor
from ..train.em import GmmAccumulator, accumulate, estimate, split
from ..train.lda import ScatterAccumulator, accumulate_scatter, estimate_lda
from ..utils.archive import FileArchive
from ..utils.component import ParameterChoice, ParameterFloat, ParameterInt, ParameterString
from .application import Application
from .feature_extraction import frontend_from_config


class AcousticModelTrainerTool(Application):
    name = "acoustic-model-trainer"
    description = "GMM acoustic model training actions"

    action = ParameterChoice(
        "action",
        ["align", "accumulate", "combine", "estimate", "split", "estimate-lda", "estimate-vtln", "estimate-fmllr", "estimate-mllr", "estimate-cart", "train", "train-mmi"],
        default="train",
    )
    corpus_file = ParameterString("corpus-file", default="")
    audio_dir = ParameterString("audio-dir", default="")
    lexicon_file = ParameterString("lexicon-file", default="")
    mixture_file = ParameterString("mixture-file", default="")
    new_mixture_file = ParameterString("new-mixture-file", default="model.mix")
    accumulator_file = ParameterString("accumulator-file", default="acc")
    alignment_cache = ParameterString("alignment-cache", default="")
    #: with BOTH caches set, action=accumulate is pure map-reduce over
    #: cached artifacts — no audio, no frontend, no aligner (ref: the
    #: reference's accumulate jobs read feature+alignment caches; §3.2)
    feature_cache = ParameterString("feature-cache", default="")
    batch_size = ParameterInt("batch-size", default=8)
    iterations = ParameterInt("iterations", default=4)
    splits = ParameterInt("splits", default=0)
    states_per_phone = ParameterInt("states-per-phone", default=3)
    var_floor = ParameterFloat("var-floor", default=0.05)
    variance_tying = ParameterChoice(
        "variance-tying", ["density", "mixture", "pooled"], default="density"
    )
    lda_output_dim = ParameterInt("lda-output-dim", default=45)
    lda_file = ParameterString("lda-output-file", default="lda.npy")
    #: estimate-vtln outputs (JSON speaker -> alpha for the
    #: feature-extraction tool's vtln-warp-file)
    vtln_output_file = ParameterString("vtln-output-file", default="vtln.json")
    vtln_max_segments = ParameterInt("vtln-max-segments", default=8)
    #: estimate-fmllr outputs (JSON speaker -> W [D, D+1] affine feature
    #: transform for --fmllr-file consumers; ref: CMLLR / MODULE_ADAPT)
    fmllr_output_file = ParameterString("fmllr-output-file", default="fmllr.json")
    fmllr_iterations = ParameterInt("fmllr-iterations", default=20)
    fmllr_min_count = ParameterFloat("fmllr-min-count", default=200.0)
    #: apply existing per-speaker transforms during align/accumulate/
    #: train — the SAT loop (adapted-space statistics stay mergeable)
    fmllr_file = ParameterString("fmllr-file", default="")
    #: estimate-mllr outputs: per-speaker mean-adapted mixture sets
    #: "<prefix><speaker>.mix" + a JSON index (model-space MLLR with
    #: regression classes; ref: MODULE_ADAPT mean adaptation)
    mllr_output_prefix = ParameterString("mllr-output-prefix", default="mllr-")
    mllr_regression_classes = ParameterInt("mllr-regression-classes", default=2)
    mllr_min_count = ParameterFloat("mllr-min-count", default=200.0)
    #: estimate-cart outputs (decision-tree state tying grown from
    #: monophone-alignment examples; consumed by the recognizer's
    #: --cart-file)
    cart_output_file = ParameterString("cart-output-file", default="cart.json")
    cart_max_leaves = ParameterInt("cart-max-leaves", default=200)
    #: train/align under an existing CART tying (the triphone stage)
    cart_file = ParameterString("cart-file", default="")
    #: train-mmi: lattice-based discriminative (EBW) training inputs
    lm_file = ParameterString("lm-file", default="")
    mmi_lm_scale = ParameterFloat("mmi-lm-scale", default=2.0)
    mmi_max_hyps = ParameterInt("mmi-max-hyps", default=256)
    mmi_word_end_limit = ParameterInt("mmi-word-end-limit", default=32)

    # ----------------------------------------------------------------- setup
    def _setup(self):
        corpus = CorpusDescription.load(self.corpus_file, audio_dir=self.audio_dir)
        lexicon = Lexicon.load(self.lexicon_file)
        topology = HmmTopology(states_per_phone=self.states_per_phone)
        if self.cart_file:
            from ..models.cart import CartTree
            from ..models.tying import CartStateTying

            tying = CartStateTying(CartTree.load(self.cart_file), lexicon)
        else:
            tying = MonophoneStateTying(lexicon, topology)
        transitions = TransitionModel.from_config(self)
        frontend = frontend_from_config(self)
        return corpus, lexicon, topology, tying, transitions, frontend

    def _batches_with_graphs(self, corpus, lexicon, tying, topology, transitions, frontend):
        transforms = None
        if self.fmllr_file:
            from ..train.fmllr import load_transforms

            transforms = load_transforms(self.fmllr_file)
        visitor = CorpusVisitor(corpus, self.batch_size)
        for batch in visitor.batches():
            feats, n_frames = frontend(batch.samples, batch.lengths)
            if transforms:
                from ..train.fmllr import transform_batch

                feats = transform_batch(feats, batch.segments, transforms)
            graphs = [
                build_linear_graph(s.orth, lexicon, tying, topology, transitions)
                for s in batch.segments
            ]
            yield batch, feats, n_frames.cpu().numpy(), graphs

    def _speaker_aligned_frames(self, corpus, lexicon, tying, topology,
                                transitions, frontend, aligner):
        """Yield (speaker, frames [n, D] on the device, aligned mixture ids
        [n]) chunks grouped by speaker — the shared accumulation walk of
        the adaptation actions (estimate-fmllr / estimate-mllr)."""
        visitor = CorpusVisitor(corpus, self.batch_size)
        by_speaker: dict = {}
        for seg in corpus.segments():
            by_speaker.setdefault(seg.speaker or "*", []).append(seg)
        for spk, segs in sorted(by_speaker.items()):
            for lo in range(0, len(segs), self.batch_size):
                chunk = segs[lo : lo + self.batch_size]
                waves = [visitor._read(s) for s in chunk]
                S = max(len(w) for w in waves)
                samples = np.zeros((len(waves), S), np.float32)
                lengths = np.zeros(len(waves), np.int64)
                for j, w in enumerate(waves):
                    samples[j, : len(w)] = w
                    lengths[j] = len(w)
                feats, nf = frontend(samples, lengths)
                nf = nf.cpu().numpy()
                graphs = [
                    build_linear_graph(s.orth, lexicon, tying, topology, transitions)
                    for s in chunk
                ]
                als = aligner.align(feats, graphs, nf)
                rows = torch.cat(
                    [feats[j, : int(nf[j])] for j in range(len(chunk))]
                )
                mix = np.concatenate([al.emission_ids for al in als])
                yield spk, rows, mix

    # ---------------------------------------------------------------- actions
    def run(self, args: List[str]) -> int:
        action = self.action
        dev = self.torch_device
        if action == "combine":
            out = GmmAccumulator.load(args[0])
            for path in args[1:]:
                out.merge(GmmAccumulator.load(path))
            out.save(self.accumulator_file)
            self.log("combined", inputs=len(args), output=self.accumulator_file)
            return 0
        if action == "estimate":
            acc = GmmAccumulator.load(self.accumulator_file)
            prev = MixtureSet.load(self.mixture_file) if self.mixture_file else None
            model = estimate(acc, prev=prev, variance_tying=self.variance_tying)
            model.save(self.new_mixture_file)
            self.log("estimated", mixtures=model.num_mixtures)
            return 0
        if action == "split":
            model = MixtureSet.load(self.mixture_file)
            acc = (
                GmmAccumulator.load(self.accumulator_file)
                if os.path.exists(self.accumulator_file + ".npz")
                else None
            )
            model = split(model, acc)
            model.save(self.new_mixture_file)
            self.log("split", max_densities=model.max_densities)
            return 0

        if action == "accumulate" and self.feature_cache and self.alignment_cache:
            # cache-driven map step: statistics straight from the
            # feature + alignment caches (align once, accumulate many —
            # the reference's incremental job-graph semantics)
            from ..align.aligner import Alignment
            from ..utils.archive import unpack_ndarray

            model = MixtureSet.load(self.mixture_file)
            acc = GmmAccumulator.zeros(*model.means.shape)
            rows_list, labels_list = [], []
            with FileArchive(self.feature_cache, "r") as fc, \
                    FileArchive(self.alignment_cache, "r") as ac:
                for name in ac.keys():
                    if name not in fc:
                        continue
                    f = unpack_ndarray(fc.read(name))
                    al = Alignment.unpack(name, ac.read(name))
                    n = min(f.shape[0], al.num_frames)
                    rows_list.append(f[:n])
                    labels_list.append(al.emission_ids[:n])
            if not rows_list:
                raise ValueError("no overlapping segments between caches")
            rows = np.concatenate(rows_list)
            labels = np.concatenate(labels_list).astype(np.int32)
            # fixed-size chunks bound the device memory of one call
            CH = 32768
            pad = (-rows.shape[0]) % CH
            rows = np.pad(rows, ((0, pad), (0, 0)))
            labels = np.pad(labels, (0, pad), constant_values=-1)
            for lo in range(0, rows.shape[0], CH):
                accumulate(acc, model, rows[lo : lo + CH], labels[lo : lo + CH],
                           device=dev)
            acc.save(self.accumulator_file)
            self.log("accumulated", frames=float(acc.count.sum()),
                     source="caches")
            return 0


        corpus, lexicon, topology, tying, transitions, frontend = self._setup()
        M = tying.num_classes

        if action == "align":
            model = MixtureSet.load(self.mixture_file)
            scorer = GmmFeatureScorer(model, var_floor=self.var_floor, device=dev)
            aligner = BatchAligner(scorer)
            with FileArchive(self.alignment_cache, "a") as cache:
                for batch, feats, nf, graphs in self._batches_with_graphs(
                    corpus, lexicon, tying, topology, transitions, frontend
                ):
                    als = aligner.align(feats, graphs, nf, batch.names)
                    for al in als:
                        cache.write(al.segment_name, al.pack())
            return 0

        if action == "accumulate":
            model = MixtureSet.load(self.mixture_file)
            scorer = GmmFeatureScorer(model, var_floor=self.var_floor, device=dev)
            aligner = BatchAligner(scorer)
            acc = GmmAccumulator.zeros(*model.means.shape)
            for batch, feats, nf, graphs in self._batches_with_graphs(
                corpus, lexicon, tying, topology, transitions, frontend
            ):
                als = aligner.align(feats, graphs, nf, batch.names)
                labels = np.full(feats.shape[:2], -1, np.int32)
                for i, al in enumerate(als):
                    labels[i, : al.num_frames] = al.emission_ids
                accumulate(acc, model, feats, labels)
            acc.save(self.accumulator_file)
            self.log("accumulated", frames=float(acc.count.sum()))
            return 0

        if action == "estimate-vtln":
            # per-speaker grid search: best total alignment likelihood
            # under warped frontends (ref: the RASR VTLN recipe)
            import json

            from ..train.vtln import estimate_warping_factor
            from .feature_extraction import frontend_spec_from_config

            corpus, lexicon, topology, tying, transitions, _ = self._setup()
            model = MixtureSet.load(self.mixture_file)
            aligner = BatchAligner(GmmFeatureScorer(model, device=dev))
            cfg, kwargs = frontend_spec_from_config(self)
            by_speaker: dict = {}
            visitor = CorpusVisitor(corpus, self.batch_size)
            for seg in corpus.segments():
                by_speaker.setdefault(seg.speaker or "*", []).append(seg)
            table = {}
            for spk, segs in sorted(by_speaker.items()):
                segs = segs[: self.vtln_max_segments]
                waves = [visitor._read(s) for s in segs]
                S = max(len(w) for w in waves)
                samples = np.zeros((len(waves), S), np.float32)
                lengths = np.zeros(len(waves), np.int64)
                for j, w in enumerate(waves):
                    samples[j, : len(w)] = w
                    lengths[j] = len(w)
                graphs = [
                    build_linear_graph(s.orth, lexicon, tying, topology, transitions)
                    for s in segs
                ]
                best, scores = estimate_warping_factor(
                    samples, lengths, graphs, aligner,
                    frontend_cfg=cfg, frontend_kwargs=kwargs, device=dev,
                )
                table[spk] = best
                self.log("vtln speaker", speaker=spk, alpha=best,
                         segments=len(segs))
            with open(self.vtln_output_file, "w") as fh:
                json.dump(table, fh)
            self.log("vtln estimated", speakers=len(table),
                     output=self.vtln_output_file)
            return 0
        if action == "estimate-fmllr":
            # per-speaker CMLLR: align each speaker's data under the
            # current model, accumulate the row statistics (device
            # einsums), solve the row-iterative update on the host
            # (ref: the adaptation pass of RASR's SAT recipes)
            from ..train.fmllr import (
                FmllrModelTensors, estimate_fmllr, fmllr_auxiliary,
                fmllr_stats, save_transforms,
            )

            model = MixtureSet.load(self.mixture_file)
            mt = FmllrModelTensors.from_mixture_set(model, var_floor=self.var_floor,
                                                    device=dev)
            aligner = BatchAligner(GmmFeatureScorer(model, var_floor=self.var_floor,
                                                    device=dev))
            D = frontend.output_dim
            acc: dict = {}
            for spk, rows, mix in self._speaker_aligned_frames(
                corpus, lexicon, tying, topology, transitions, frontend, aligner
            ):
                G, k, b = fmllr_stats(rows, mix, mt)
                Gs, ks, beta = acc.setdefault(
                    spk, [np.zeros((D, D + 1, D + 1)), np.zeros((D, D + 1)), 0.0]
                )
                acc[spk] = [Gs + G, ks + k, beta + b]
            table = {}
            ident = np.hstack([np.eye(D), np.zeros((D, 1))])
            for spk, (Gs, ks, beta) in sorted(acc.items()):
                W = estimate_fmllr(
                    Gs, ks, beta, iterations=self.fmllr_iterations,
                    min_count=self.fmllr_min_count,
                )
                table[spk] = W
                self.log(
                    "fmllr speaker", speaker=spk, frames=beta,
                    gain=(fmllr_auxiliary(Gs, ks, beta, W)
                          - fmllr_auxiliary(Gs, ks, beta, ident)) / max(beta, 1.0),
                )
            save_transforms(self.fmllr_output_file, table)
            self.log("fmllr estimated", speakers=len(table),
                     output=self.fmllr_output_file)
            return 0
        if action == "estimate-mllr":
            # per-speaker model-space MLLR: mean transforms over
            # regression classes, written as adapted mixture sets
            # (decode a speaker with --mixture-file=<prefix><spk>.mix,
            # e.g. via the recognizer's --speaker filter)
            import json as _json

            from ..train.fmllr import FmllrModelTensors
            from ..train.mllr import (
                adapt_means, default_regression_classes, estimate_mllr,
                mllr_stats,
            )

            model = MixtureSet.load(self.mixture_file)
            mt = FmllrModelTensors.from_mixture_set(model, var_floor=self.var_floor,
                                                    device=dev)
            classes = default_regression_classes(
                model, self.mllr_regression_classes
            )
            aligner = BatchAligner(GmmFeatureScorer(model, var_floor=self.var_floor,
                                                    device=dev))
            acc: dict = {}
            for spk, rows, mix in self._speaker_aligned_frames(
                corpus, lexicon, tying, topology, transitions, frontend, aligner
            ):
                gb, gxb = mllr_stats(rows, mix, mt)
                g, gx = acc.setdefault(
                    spk, [np.zeros(model.weights.shape), np.zeros(model.means.shape)]
                )
                acc[spk] = [g + gb, gx + gxb]
            index = {}
            for spk, (g, gx) in sorted(acc.items()):
                W = estimate_mllr(
                    g, gx, model, classes=classes,
                    min_count=self.mllr_min_count, var_floor=self.var_floor,
                )
                adapted = adapt_means(model, W, classes)
                # "*" is the no-speaker group; keep filenames glob-safe
                path = f"{self.mllr_output_prefix}{spk if spk != '*' else 'default'}.mix"
                adapted.save(path)
                index[spk] = path
                self.log("mllr speaker", speaker=spk, frames=float(g.sum()),
                         classes=len(W), output=path)
            with open(self.mllr_output_prefix + "index.json", "w") as fh:
                _json.dump(index, fh)
            self.log("mllr estimated", speakers=len(index))
            return 0
        if action == "estimate-cart":
            # CART example accumulation + tree growing (ref: the
            # acoustic-model-trainer's CART actions): frames label with
            # their FULL allophone-state context recovered from the
            # Viterbi chain-state path (graphs keep allophone states),
            # then likelihood-gain splitting over phonetic questions.
            from ..models.cart import CartExamples, CartTree, default_questions

            corpus, lexicon, topology, tying, transitions, frontend = self._setup()
            model = MixtureSet.load(self.mixture_file)
            aligner = BatchAligner(GmmFeatureScorer(model, device=dev))
            ex = CartExamples(frontend.output_dim)
            for batch, feats, nf, graphs in self._batches_with_graphs(
                corpus, lexicon, tying, topology, transitions, frontend
            ):
                als = aligner.align(feats, graphs, nf, batch.names)
                feats = feats.cpu().numpy()  # the examples are host statistics
                for i, (al, g) in enumerate(zip(als, graphs)):
                    keys = [
                        (
                            g.states[si].allophone.left,
                            g.states[si].allophone.center,
                            g.states[si].allophone.right,
                            g.states[si].state,
                        )
                        for si in al.state_indices
                    ]
                    ex.add_frames(keys, feats[i, : al.num_frames], al.weights)
            t0 = time.perf_counter()
            tree = CartTree.train(
                ex, default_questions(lexicon), max_leaves=self.cart_max_leaves
            )
            tree.save(self.cart_output_file)
            self.log(
                "cart estimated", leaves=tree.num_classes,
                contexts=len(ex.stats), output=self.cart_output_file,
                train_seconds=time.perf_counter() - t0,
            )
            return 0
        if action == "train-mmi":
            # lattice-based MMI via extended Baum-Welch (ref: the
            # MODULE_SPEECH_DT discriminative pipeline — numerator from
            # forced alignments, denominator from decoding lattices,
            # EBW mixture updates), iterated self.iterations times.
            from ..lattice.lattice import decoder_lattice
            from ..models.lm.arpa import NgramLm
            from ..models.lm.ngram import compile_ngram
            from ..search.decoder import BeamConfig, TreeDecoder
            from ..search.tree import build_prefix_tree
            from ..train.discriminative import (
                MmiAccumulators,
                accumulate_denominator_from_lattice,
                accumulate_numerator,
                ebw_update,
            )

            assert self.lm_file, "train-mmi needs lm-file (denominator lattices)"
            corpus, lexicon, topology, tying, transitions, frontend = self._setup()
            model = MixtureSet.load(self.mixture_file)
            lm = NgramLm.read_arpa(self.lm_file)
            tables = compile_ngram(lm)
            tree = build_prefix_tree(
                lexicon, tying, topology, transitions, lm_vocab=lm.vocab
            )
            cfg = BeamConfig(
                max_hyps=self.mmi_max_hyps,
                word_end_limit=self.mmi_word_end_limit,
                lm_scale=self.mmi_lm_scale,
            )
            decoder = TreeDecoder(tree, tables, cfg, device=dev)
            M, K, D = model.means.shape
            for it in range(self.iterations):
                acc = MmiAccumulators.zeros(M, K, D)
                scorer = GmmFeatureScorer(model, device=dev)
                aligner = BatchAligner(scorer)
                for batch, feats, nf, graphs in self._batches_with_graphs(
                    corpus, lexicon, tying, topology, transitions, frontend
                ):
                    als = aligner.align(feats, graphs, nf, batch.names)
                    labels = np.full(feats.shape[:2], -1, np.int32)
                    for i, al in enumerate(als):
                        labels[i, : al.num_frames] = al.emission_ids
                    accumulate_numerator(acc, model, feats, labels)
                    handle = decoder.decode_scores_device(scorer(feats), nf)
                    host_feats = feats.cpu().numpy()
                    for i in range(feats.shape[0]):
                        lat = decoder_lattice(handle, decoder.tree.lemmas, i)
                        accumulate_denominator_from_lattice(
                            acc, model, host_feats[i, : int(nf[i])], lat, aligner,
                            lexicon, tying, topology, transitions,
                            lm_scale=self.mmi_lm_scale,
                        )
                model = ebw_update(model, acc)
                self.log(
                    "mmi iteration", iteration=it,
                    num_frames=float(acc.num.count.sum()),
                    den_frames=float(acc.den.count.sum()),
                )
            model.save(self.new_mixture_file)
            self.log("mmi trained", output=self.new_mixture_file)
            return 0
        if action == "estimate-lda":
            model = MixtureSet.load(self.mixture_file)
            scorer = GmmFeatureScorer(model, var_floor=self.var_floor, device=dev)
            aligner = BatchAligner(scorer)
            acc = None
            for batch, feats, nf, graphs in self._batches_with_graphs(
                corpus, lexicon, tying, topology, transitions, frontend
            ):
                if acc is None:
                    acc = ScatterAccumulator.zeros(M, feats.shape[-1])
                als = aligner.align(feats, graphs, nf, batch.names)
                labels = np.full(feats.shape[:2], -1, np.int32)
                for i, al in enumerate(als):
                    labels[i, : al.num_frames] = al.emission_ids
                accumulate_scatter(acc, feats, labels)
            lda, eigvals = estimate_lda(acc, self.lda_output_dim)
            np.save(self.lda_file, lda)
            self.log("lda estimated", output_dim=self.lda_output_dim)
            return 0

        # action == train: full iteration scheme with flat start
        dim_probe = frontend.output_dim
        model = MixtureSet.single_density(
            np.zeros((M, dim_probe), np.float32), np.ones((M, dim_probe), np.float32)
        )
        first = True
        for it in range(self.iterations):
            acc = GmmAccumulator.zeros(*model.means.shape)
            scorer = GmmFeatureScorer(model, var_floor=self.var_floor, device=dev)
            aligner = BatchAligner(scorer)
            total_score = 0.0
            for batch, feats, nf, graphs in self._batches_with_graphs(
                corpus, lexicon, tying, topology, transitions, frontend
            ):
                if first:
                    labels = linear_segmentation(graphs, nf)
                    pad = feats.shape[1] - labels.shape[1]
                    if pad > 0:
                        labels = np.pad(labels, ((0, 0), (0, pad)), constant_values=-1)
                else:
                    als = aligner.align(feats, graphs, nf, batch.names)
                    labels = np.full(feats.shape[:2], -1, np.int32)
                    for i, al in enumerate(als):
                        labels[i, : al.num_frames] = al.emission_ids
                        total_score += al.score
                accumulate(acc, model, feats, labels)
            model = estimate(acc, prev=None if first else model,
                             variance_tying=self.variance_tying)
            first = False
            self.log("iteration", iteration=it, score=total_score)
            if self.splits > 0 and it >= self.iterations - self.splits - 1 and it < self.iterations - 1:
                model = split(model, acc)
        model.save(self.new_mixture_file)
        self.log("trained", output=self.new_mixture_file, densities=int(model.num_densities.sum()))
        return 0


if __name__ == "__main__":
    raise SystemExit(AcousticModelTrainerTool.main())
