"""flf-tool (ref: src/Tools/Flf/).

Runs a chain of lattice processors over a lattice archive, mirroring the
reference's FLF processing networks as a linear ``ops`` list:

    [flf-tool]
    lattice-archive = lattices.cache
    corpus-file     = test.corpus       # for reference orths (evaluate)
    ops             = prune best evaluate
    posterior-threshold = 10.0
    lm-file         = rescoring.arpa    # for op 'rescore'
    output-archive  = out.cache         # for op 'write'

Ops: prune rescore rescore-am best cn-decode fcn-decode nbest oracle
evaluate write union intersect (vs second-archive; system combination)
map (map-file) scale confidence. 'rescore-am' (the legacy
lattice-processor's acoustic rescoring) re-aligns every word arc over
its time span under a new acoustic model, reading features from
``feature-cache`` (lattice/rescore.py — one batched banded-Viterbi call
per lattice).

The acoustic rescoring and an RNN LM compute on the tool's ``device``
(the card unless the configuration names another); the lattice
operations are host work.
"""

from __future__ import annotations

from typing import List

from ..corpus.bliss import CorpusDescription
from ..lattice.evaluator import CorpusEvaluator, lattice_oracle
from ..lattice.flf import (
    best_path, cn_decode, confusion_network, fcn_decode, intersect, map_lemmas, n_best,
    posterior_prune, rescore_lm, scale_scores, time_frame_cn, union,
    word_confidence,
)
from ..lattice.lattice import Lattice
from ..models.lm.arpa import NgramLm
from ..utils.archive import FileArchive, open_archive
from ..utils.component import (
    ParameterChoice, ParameterFloat, ParameterInt, ParameterString,
)
from .application import Application


class FlfTool(Application):
    name = "flf-tool"
    description = "lattice processing: prune/rescore/best/CN/evaluate"

    lattice_archive = ParameterString("lattice-archive")
    output_archive = ParameterString("output-archive", default="")
    corpus_file = ParameterString("corpus-file", default="")
    ops = ParameterString("ops", default="best")
    posterior_threshold = ParameterFloat("posterior-threshold", default=10.0)
    lm_file = ParameterString("lm-file", default="")
    #: rescoring LM type: "ngram" = ARPA file, "rnn" = RnnLm image
    #: (ref: lattice rescoring with the TF RNN LM — a torch LSTM here)
    lm_type = ParameterChoice("lm-type", ["ngram", "rnn"], default="ngram")
    lm_scale = ParameterFloat("lm-scale", default=1.0)
    am_scale = ParameterFloat("am-scale", default=1.0)
    nbest = ParameterInt("nbest", default=10)
    # second archive for the binary ops 'union' / 'intersect'
    # (system combination: same segment names in both archives)
    second_archive = ParameterString("second-archive", default="")
    # orthography map for op 'map': lines of "<from> <to>"
    map_file = ParameterString("map-file", default="")
    # op 'rescore-am' (the legacy lattice-processor's acoustic
    # rescoring): re-align each word arc over its time span under the
    # given acoustic model, reading features from a feature cache
    # (the reference workflow: LatticeProcessor consumes feature caches)
    feature_cache = ParameterString("feature-cache", default="")
    lexicon_file = ParameterString("lexicon-file", default="")
    mixture_file = ParameterString("mixture-file", default="")
    cart_file = ParameterString("cart-file", default="")
    states_per_phone = ParameterInt("states-per-phone", default=3)
    silence_states = ParameterInt("silence-states", default=1)
    rescore_am_scale = ParameterFloat("rescore-am-scale", default=1.0)

    def run(self, args: List[str]) -> int:
        ops = self.ops.split()
        orths = {}
        if self.corpus_file:
            corpus = CorpusDescription.load(self.corpus_file)
            orths = {s.full_name: s.orth for s in corpus.segments()}
        rescore_model = None
        if self.lm_file:
            if self.lm_type == "rnn":
                from ..models.lm.rnn import RnnLm

                rescore_model = RnnLm.load(self.lm_file, device=self.torch_device)
            else:
                rescore_model = NgramLm.read_arpa(self.lm_file)
        orth_map = {}
        if self.map_file:
            with open(self.map_file) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        orth_map[parts[0]] = parts[1]
        am_ctx = None
        if "rescore-am" in ops:
            if not (self.feature_cache and self.lexicon_file and self.mixture_file):
                raise ValueError(
                    "rescore-am needs feature-cache, lexicon-file, mixture-file"
                )
            from ..corpus.lexicon import Lexicon
            from ..models.gmm import MixtureSet
            from ..models.hmm import HmmTopology, TransitionModel
            from ..models.scorer import GmmFeatureScorer
            from ..models.tying import CartStateTying, MonophoneStateTying
            from ..pipeline.feature_extractor import load_features

            lexicon = Lexicon.load(self.lexicon_file)
            topo = HmmTopology(
                states_per_phone=self.states_per_phone,
                silence_states=self.silence_states,
            )
            # TDPs baked into the rescored am scores must be matchable
            # to the recognizer's: read <flf-tool>.tdp.speech.* /
            # tdp.silence.* exactly like the recognizer does
            transitions = TransitionModel.from_config(self)
            if self.cart_file:
                from ..models.cart import CartTree

                tying = CartStateTying(CartTree.load(self.cart_file), lexicon)
            else:
                tying = MonophoneStateTying(lexicon, topo)
            scorer = GmmFeatureScorer(
                MixtureSet.load(self.mixture_file), scale=self.rescore_am_scale,
                device=self.torch_device,
            )
            am_ctx = (lexicon, tying, topo, transitions, scorer, load_features)
        second = open_archive(self.second_archive) if self.second_archive else None
        evaluator = CorpusEvaluator()
        oracle_errs, oracle_words = 0, 0
        out = FileArchive(self.output_archive, "a") if self.output_archive else None
        archive = open_archive(self.lattice_archive)
        try:
            for name in archive.keys():
                lat = Lattice.unpack(archive.read(name))
                hyp_words: List[str] = []
                for op in ops:
                    if op == "prune":
                        lat = posterior_prune(
                            lat, self.posterior_threshold, self.am_scale, self.lm_scale
                        )
                    elif op == "rescore":
                        if rescore_model is None:
                            raise ValueError("rescore needs lm-file")
                        synt = {
                            i: rescore_model.vocab.get(orth)
                            for i, orth in enumerate(lat.lemma_orths)
                        }
                        lat = rescore_lm(lat, rescore_model, synt)
                    elif op == "rescore-am":
                        from ..lattice.rescore import rescore_am

                        lexicon, tying, topo, trans, scorer, load_features = am_ctx
                        feats = load_features(self.feature_cache, name)
                        emis = scorer(feats[None])[0]  # [T, M] on the device
                        lat = rescore_am(lat, emis, lexicon, tying, topo, trans)
                    elif op == "best":
                        _, path = best_path(lat, self.am_scale, self.lm_scale)
                        hyp_words = [
                            lat.lemma_orths[a.lemma]
                            for a in path
                            if a.lemma >= 0  # skip eps (e.g. union entry arcs)
                            and not lat.lemma_orths[a.lemma].startswith("[")
                        ]
                    elif op == "cn-decode":
                        slots = confusion_network(lat, self.am_scale, self.lm_scale)
                        hyp_words = [
                            w for w in cn_decode(slots) if not w.startswith("[")
                        ]
                    elif op == "fcn-decode":
                        # min-fWER decode over the time-frame CN
                        frames = time_frame_cn(lat, self.am_scale, self.lm_scale)
                        hyp_words = [
                            w for w in fcn_decode(frames) if not w.startswith("[")
                        ]
                    elif op == "nbest":
                        nb = n_best(lat, self.nbest, self.am_scale, self.lm_scale)
                        self.log("nbest", segment=name, count=len(nb))
                    elif op in ("union", "intersect"):
                        if second is None:
                            raise ValueError(f"{op} needs second-archive")
                        other = Lattice.unpack(second.read(name))
                        lat = (union([lat, other]) if op == "union"
                               else intersect(lat, other))
                    elif op == "map":
                        lat = map_lemmas(lat, orth_map)
                    elif op == "scale":
                        lat = scale_scores(lat, self.am_scale, self.lm_scale)
                    elif op == "confidence":
                        confs = word_confidence(lat, self.am_scale, self.lm_scale)
                        self.log("confidence", segment=name,
                                 words=[[w, round(c, 4)] for w, c in confs])
                    elif op == "oracle":
                        ref = orths.get(name, "").split()
                        errs, _ = lattice_oracle(lat, ref)
                        oracle_errs += errs
                        oracle_words += len(ref)
                    elif op == "evaluate":
                        ref = orths.get(name, "")
                        if ref:
                            evaluator.add(name, ref, " ".join(hyp_words))
                    elif op == "write":
                        pass  # written below
                    else:
                        raise ValueError(f"unknown op {op!r}")
                if out is not None:
                    out.write(name, lat.pack())
        finally:
            archive.close()
            if second is not None:
                second.close()
            if out is not None:
                out.close()
        if "evaluate" in ops:
            report = evaluator.report()
            self.log("evaluation", **report)
            print(f"WER: {report['wer']:.4f}")
        if "oracle" in ops and oracle_words:
            self.log("oracle", oracle_wer=oracle_errs / oracle_words)
            print(f"oracle WER: {oracle_errs / oracle_words:.4f}")
        return 0


if __name__ == "__main__":
    raise SystemExit(FlfTool.main())
