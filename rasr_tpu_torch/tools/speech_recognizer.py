"""speech-recognizer tool (ref: src/Tools/SpeechRecognizer/).

Offline recognition over a corpus: frontend -> scorer -> prefix-tree
beam decode, with online WER against reference orth, per-segment
structured log records, and optional lattice archive output.

Config::

    [speech-recognizer]
    corpus-file = test.corpus
    lexicon-file = lexicon.xml
    lm-file = lm.arpa
    mixture-file = model.mix.npz      # or nn params via nn-* params
    lattice-archive = lattices.cache  # optional
    [speech-recognizer.search]
    max-hyps = 1024
    beam = 20.0
    lm-scale = 10.0

Everything computes on the tool's ``device`` (the card unless the
configuration names another). The nn-hybrid scorer reads the port's
``FeedForwardNet`` parameters as ``NnTrainer.save_params`` writes them
(``torch.save``). The search configuration is logged as one
``search configuration`` record, and the network's setup time as
``network ready``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

from ..corpus.bliss import CorpusDescription
from ..corpus.lexicon import Lexicon
from ..models.gmm import MixtureSet
from ..models.hmm import HmmTopology, TransitionModel
from ..models.lm.arpa import NgramLm
from ..models.lm.ngram import compile_ngram, load_tables, save_tables
from ..models.scorer import GmmFeatureScorer
from ..models.tying import CartStateTying, MonophoneStateTying
from ..models.cart import CartTree
from ..pipeline.recognizer import OfflineRecognizer
from ..pipeline.visitor import CorpusVisitor
from ..search.decoder import BeamConfig, TreeDecoder
from ..search.lookahead import (
    build_bigram_lookahead,
    load_bigram_lookahead,
    save_bigram_lookahead,
)
from ..search.tree import build_prefix_tree, load_tree, save_tree
from ..utils.component import (
    ParameterBool,
    ParameterFloat,
    ParameterInt,
    ParameterString,
)
from .application import Application
from .feature_extraction import frontend_from_config


class SpeechRecognizerTool(Application):
    name = "speech-recognizer"
    description = "offline corpus recognition with WER and lattice output"

    corpus_file = ParameterString("corpus-file")
    audio_dir = ParameterString("audio-dir", default="")
    lexicon_file = ParameterString("lexicon-file")
    lm_file = ParameterString("lm-file")
    mixture_file = ParameterString("mixture-file", default="")
    cart_file = ParameterString("cart-file", default="")
    lattice_archive = ParameterString("lattice-archive", default="")
    batch_size = ParameterInt("batch-size", default=8)
    am_scale = ParameterFloat("am-scale", default=1.0)
    states_per_phone = ParameterInt("states-per-phone", default=3)
    # ref: feature-scorer-type selection (Mm registry seam)
    feature_scorer_type = ParameterString("feature-scorer-type", default="gmm")
    nn_params_file = ParameterString("nn-params-file", default="")
    nn_priors_file = ParameterString("nn-priors-file", default="")
    nn_hidden = ParameterString("nn-hidden-layers", default="512 512")
    prior_scale = ParameterFloat("prior-scale", default=1.0)
    nn_compute_dtype = ParameterString("nn-compute-dtype", default="float32")
    #: image cache for the compiled search network + LM tables (ref:
    #: the reference's image/dump caching): first run builds and
    #: saves, later runs load in seconds. Stale images (changed
    #: lexicon/LM/topology) are detected by content hash and rebuilt.
    network_cache = ParameterString("network-cache", default="")
    #: decode from a feature cache archive (keyed by segment name)
    #: instead of extracting features from audio (ref: cache-driven
    #: recognition — reruns skip the frontend and the audio entirely)
    feature_cache = ParameterString("feature-cache", default="")
    #: per-speaker fMLLR/CMLLR transforms (JSON {speaker: W}, from the
    #: acoustic-model-trainer's estimate-fmllr action) applied to the
    #: features before scoring (ref: the adaptation pass / MODULE_ADAPT)
    fmllr_file = ParameterString("fmllr-file", default="")
    #: restrict recognition to one speaker's segments (e.g. decoding
    #: with that speaker's MLLR-adapted mixture set) — the in-tool form
    #: of the reference's segment-selection lists
    speaker = ParameterString("speaker", default="")
    #: or an explicit segment list file (one full segment name per line)
    segment_list_file = ParameterString("segment-list-file", default="")
    #: CTM output: one "<recording> <channel> <begin_s> <dur_s> <word>"
    #: line per recognized word (absolute times from the decoder's
    #: word-end frames — the standard scoring-tool interchange format)
    ctm_file = ParameterString("ctm-file", default="")
    #: n-best list output from the decode lattices:
    #: "<segment> <rank> <score> <words>" per hypothesis
    nbest_file = ParameterString("nbest-file", default="")
    nbest = ParameterInt("nbest", default=10)
    #: model word-boundary triphone contexts exactly (across-word search
    #: network: context-conditioned roots + word-end right-context
    #: fan-out) instead of the within-word # approximation (ref: the
    #: reference decoders' across-word model support)
    across_word = ParameterBool("across-word", default=False)
    #: first-pass RNN-LM fusion: path prefix of a saved RnnLm
    #: (models/lm/rnn.py save()); scores fuse log-linearly into the
    #: word-end LM application during search (ref: the reference's
    #: Lm::TFRecurrentLanguageModel in-search neural LM). Weight via
    #: search.rnn-scale.
    rnn_lm_file = ParameterString("rnn-lm-file", default="")
    #: which finite-skip TDP transitions the search network realizes:
    #: "word" = over each word's whole state chain (the reference's
    #: topology; matches the alignment graphs), "phone" = within phones
    #: only (leaner network; identical when tdp skip = inf)
    skip_scope = ParameterString("skip-scope", default="word")

    def _network(self, lexicon, tying, topology, transitions, search):
        """Compiled search network + LM tables (+ optional bigram
        lookahead), via the image cache."""
        import hashlib
        import os

        la_order = int(search.param("lookahead-order", 1))
        la_classes = int(search.param("lookahead-classes", 64))
        la_smooth = float(search.param("lookahead-smooth", 0.0))
        cache = self.network_cache
        if cache:
            h = hashlib.sha1()
            for f in (self.lexicon_file, self.lm_file, self.cart_file):
                if f and os.path.exists(f):
                    with open(f, "rb") as fh:
                        h.update(fh.read())
            h.update(str(self.states_per_phone).encode())
            h.update(str(bool(self.across_word)).encode())
            h.update(self.skip_scope.encode())
            h.update(f"la{la_order}/{la_classes}/{la_smooth}".encode())
            # the TDPs are baked into the tree's loop/arc/word-end costs
            h.update(repr(transitions).encode())
            key = h.hexdigest()
            if os.path.exists(cache + ".key"):
                with open(cache + ".key") as fh:
                    stale = fh.read().strip() != key
            else:
                stale = True
            if not stale:
                try:
                    tree = load_tree(cache + ".tree.npz", lexicon)
                    tables = load_tables(cache + ".lm.npz")
                    bla = None
                    if la_order >= 2 and os.path.exists(cache + ".la.npz"):
                        bla = load_bigram_lookahead(cache + ".la.npz")
                    self.log("network image loaded", cache=cache)
                    return tree, tables, bla
                except (OSError, ValueError, KeyError) as exc:
                    self.warning(f"network image unusable ({exc}); rebuilding")
        lm = NgramLm.read_arpa(self.lm_file)
        tables = compile_ngram(lm)
        unigrams = {wid: lm.score((), wid) for wid in lm.vocab.values()}
        tree = build_prefix_tree(
            lexicon, tying, topology, transitions, lm_vocab=lm.vocab,
            lm_unigrams=unigrams, across_word=bool(self.across_word),
            skip_scope=self.skip_scope,
        )
        bla = None
        if la_order >= 2:
            bla = build_bigram_lookahead(
                tree, lm, num_classes=la_classes,
                order=min(la_order, 3),
                smooth=la_smooth,
            )
            if bla is None:
                self.warning(
                    "lookahead-order=2 unsupported for this network "
                    "(non-root word-end re-entries — general WFST "
                    "graphs); falling back to unigram shaping"
                )
        if cache:
            save_tree(tree, cache + ".tree.npz")
            save_tables(tables, cache + ".lm.npz")
            if bla is not None:
                save_bigram_lookahead(bla, cache + ".la.npz")
            with open(cache + ".key", "w") as fh:
                fh.write(key)
            self.log("network image saved", cache=cache)
        return tree, tables, bla

    def run(self, args: List[str]) -> int:
        dev = self.torch_device
        corpus = CorpusDescription.load(self.corpus_file, audio_dir=self.audio_dir)
        lexicon = Lexicon.load(self.lexicon_file)
        topology = HmmTopology(states_per_phone=self.states_per_phone)
        if self.cart_file:
            tying = CartStateTying(CartTree.load(self.cart_file), lexicon)
        else:
            tying = MonophoneStateTying(lexicon, topology)
        transitions = TransitionModel.from_config(self)
        frontend = frontend_from_config(self)
        if self.feature_scorer_type in ("nn-hybrid", "nn-precomputed-hybrid"):
            from ..models.nn import FeedForwardNet, NnHybridScorer, StatePriors
            from ..train.nn_trainer import NnTrainer

            priors = StatePriors.load(self.nn_priors_file)
            net = FeedForwardNet(
                num_classes=priors.log_priors.shape[0],
                in_dim=frontend.output_dim,
                hidden=tuple(int(h) for h in self.nn_hidden.split()),
                compute_dtype=self.nn_compute_dtype,
                device=dev,
            )
            params = NnTrainer.load_params(self.nn_params_file, map_location=dev)
            scorer = NnHybridScorer(
                net, params, priors, scale=self.am_scale,
                prior_scale=self.prior_scale, device=dev,
            )
        else:
            mixtures = MixtureSet.load(self.mixture_file)
            scorer = GmmFeatureScorer(mixtures, scale=self.am_scale, device=dev)
        search = self.select("search")
        t0 = time.perf_counter()
        tree, tables, bla = self._network(
            lexicon, tying, topology, transitions, search
        )
        cfg = BeamConfig(
            max_hyps=int(search.param("max-hyps", 1024)),
            beam=float(search.param("beam", 1e9)),
            word_end_limit=int(search.param("word-end-limit", 128)),
            word_end_beam=float(search.param("word-end-beam", 1e9)),
            word_end_rank_lm=bool(search.param("word-end-rank-lm", False)),
            root_hyps=int(search.param("root-hyps", 32)),
            root_arc_limit=int(search.param("root-arc-limit", 0)),
            branch_hyps=int(search.param("branch-hyps", 0)),
            branch_width=int(search.param("branch-width", 0)),
            expansion_limit=int(search.param("expansion-limit", 0)),
            root_select=int(search.param("root-select", 0)),
            deferred_emission=bool(search.param("deferred-emission", False)),
            lookahead_scale=float(search.param("lookahead-scale", 1.0)),
            # separate weight on the bigram/trigram CORRECTION level
            # (the reference's lookahead-LM scale; battery evidence in
            # BASELINE.md — full-strength corrections over-commit
            # tight beams)
            lookahead_corr_scale=float(
                search.param("lookahead-corr-scale", 1.0)
            ),
            # "survivor" = lazy correction updates (the reference's
            # activation-on-node-entry; NOT exact — see BeamConfig)
            lookahead_update=str(
                search.param("lookahead-update", "arc")
            ),
            lm_scale=float(search.param("lm-scale", 10.0)),
        )
        rnn_fusion = None
        if self.rnn_lm_file:
            from ..models.lm.rnn import RnnLm
            from ..search.rnn_fusion import build_rnn_fusion

            rnn_lm = RnnLm.load(self.rnn_lm_file, device=dev)
            # decoder word ids are the n-gram LM's: rebuild its vocab
            # (cheap next to the decode; works with cached networks too)
            ngram_vocab = NgramLm.read_arpa(self.lm_file).vocab
            rnn_fusion = build_rnn_fusion(
                rnn_lm, ngram_vocab,
                weight=float(search.param("rnn-scale", 0.5)),
                device=dev,
            )
            self.log(
                "rnn fusion enabled",
                hidden=rnn_fusion.hidden,
                weight=rnn_fusion.weight,
            )
        decoder = TreeDecoder(
            tree, tables, cfg, bigram_la=bla, rnn_fusion=rnn_fusion, device=dev
        )
        self.log("search configuration", **dataclasses.asdict(cfg))
        self.log("network ready", seconds=time.perf_counter() - t0,
                 states=int(tree.num_states))
        transforms = None
        if self.fmllr_file:
            from ..train.fmllr import load_transforms

            transforms = load_transforms(self.fmllr_file)
        rec = OfflineRecognizer(
            frontend, scorer, decoder,
            lattice_archive=self.lattice_archive or None,
            feature_cache=self.feature_cache or None,
            feature_transforms=transforms,
            ctm_file=self.ctm_file or None,
            nbest_file=self.nbest_file or None,
            nbest=self.nbest,
        )
        segment_list = None
        if self.segment_list_file:
            with open(self.segment_list_file) as fh:
                segment_list = [ln.strip() for ln in fh if ln.strip()]
        elif self.speaker:
            segment_list = [
                s.full_name for s in corpus.segments()
                if (s.speaker or "*") == self.speaker
            ]
        if segment_list is not None and not segment_list:
            # decoding nothing would print "WER: 0.0000" — a false pass
            raise ValueError(
                f"segment selection matched no segments "
                f"(speaker={self.speaker!r}, list={self.segment_list_file!r})"
            )
        rec.run(
            CorpusVisitor(
                corpus, self.batch_size,
                segment_list=segment_list,
                load_audio=not self.feature_cache,
            )
        )
        report = rec.evaluator.report()
        self.log("recognition finished", **report)
        print(f"WER: {report['wer']:.4f} ({report['errors']} errors / {report['ref_len']} words)")
        return 0


if __name__ == "__main__":
    raise SystemExit(SpeechRecognizerTool.main())
