"""nn-trainer tool (ref: src/Tools/NnTrainer/).

Actions mirroring the reference's nn-trainer:
* ``action=supervised-training``: train the FFNN on feature+alignment caches
* ``action=estimate-priors``: state-prior estimation from alignments
* ``action=sequence-mmi-training``: lattice-free MMI through a sequence encoder
* ``action=sequence-smbr-training``: lattice-free sMBR (expected accuracy
  over the denominator posterior vs forced-alignment labels; needs
  ``--alignment-cache``; ``--smbr-accuracy=phone`` for MPE-style phone
  accuracy instead of tied-state accuracy)

The networks train on the tool's ``device`` (the card unless the
configuration names another). Parameter files hold the port's
``torch.save`` state_dict (``NnTrainer.save_params``), whatever their
name says (``nn.msgpack`` in the reference's recipes); a network the JAX
tools trained crosses over through ``convert.nn_params_from_flax``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..align.aligner import Alignment
from ..models.nn import FeedForwardNet
from ..train.nn_trainer import FrameDataset, NnTrainer, TrainConfig
from ..utils.archive import FileArchive, unpack_ndarray
from ..utils.component import (
    ParameterChoice, ParameterFloat, ParameterInt, ParameterIntList,
    ParameterString,
)
from .application import Application


def _load_frames(feature_cache: str, alignment_cache: str):
    feats_list, labels_list, weights_list = [], [], []
    with FileArchive(feature_cache, "r") as fc, FileArchive(alignment_cache, "r") as ac:
        for name in ac.keys():
            if name not in fc:
                continue
            feats = unpack_ndarray(fc.read(name))
            al = Alignment.unpack(name, ac.read(name))
            n = min(feats.shape[0], al.num_frames)
            feats_list.append(feats[:n])
            labels_list.append(al.emission_ids[:n])
            weights_list.append(al.weights[:n] if al.weights is not None else np.ones(n, np.float32))
    if not feats_list:
        raise ValueError("no overlapping segments between caches")
    return (
        np.concatenate(feats_list),
        np.concatenate(labels_list),
        np.concatenate(weights_list),
    )


def _load_sequences(feature_cache: str, alignment_cache: str):
    """Per-utterance padded tensors [N, Tmax, D] / [N, Tmax] (-1 pad)
    for recurrent training."""
    pairs = []
    with FileArchive(feature_cache, "r") as fc, FileArchive(alignment_cache, "r") as ac:
        for name in ac.keys():
            if name not in fc:
                continue
            feats = unpack_ndarray(fc.read(name))
            al = Alignment.unpack(name, ac.read(name))
            n = min(feats.shape[0], al.num_frames)
            pairs.append((feats[:n], al.emission_ids[:n]))
    if not pairs:
        raise ValueError("no overlapping segments between caches")
    Tmax = max(f.shape[0] for f, _ in pairs)
    D = pairs[0][0].shape[1]
    feats = np.zeros((len(pairs), Tmax, D), np.float32)
    labels = np.full((len(pairs), Tmax), -1, np.int32)
    for i, (f, l) in enumerate(pairs):
        feats[i, : f.shape[0]] = f
        labels[i, : l.shape[0]] = l
    return feats, labels


class NnTrainerTool(Application):
    name = "nn-trainer"
    description = "hybrid NN acoustic model training"

    action = ParameterChoice(
        "action",
        ["supervised-training", "estimate-priors", "sequence-mmi-training",
         "sequence-smbr-training"],
        default="supervised-training",
    )
    #: ffnn = framewise (ref: Nn::FeedForwardTrainer); blstm/conformer =
    #: sequence encoders trained on whole utterances (ref reaches these
    #: only via the TF bridge)
    model_type = ParameterChoice(
        "model-type", ["ffnn", "blstm", "conformer"], default="ffnn"
    )
    feature_cache = ParameterString("feature-cache")
    alignment_cache = ParameterString("alignment-cache")
    num_classes = ParameterInt("num-classes")
    hidden = ParameterIntList("hidden-layers", default=[512, 512])
    activation = ParameterString("activation", default="relu")
    params_file = ParameterString("params-file", default="nn.msgpack")
    priors_file = ParameterString("priors-file", default="priors.npy")
    batch_size = ParameterInt("batch-size", default=256)
    epochs = ParameterInt("epochs", default=5)
    learning_rate = ParameterFloat("learning-rate", default=1e-3)
    l2 = ParameterFloat("l2", default=0.0)
    optimizer = ParameterChoice("optimizer", ["sgd", "momentum", "adam"], default="momentum")
    seed = ParameterInt("seed", default=0)
    #: "bfloat16" runs the products in bf16 on the tensor cores
    compute_dtype = ParameterChoice(
        "compute-dtype", ["float32", "bfloat16"], default="float32"
    )
    #: directory for full-state (params+optimizer+cursor) checkpoints;
    #: empty = artifact-only resume like the reference (SURVEY §5)
    checkpoint_dir = ParameterString("checkpoint-dir", default="")
    checkpoint_every = ParameterInt("checkpoint-every", default=0)  # steps
    resume = ParameterInt("resume", default=1)  # restore latest if present
    #: sequence-mmi-training inputs: numerator graphs come from corpus
    #: orths (like the acoustic-model-trainer), denominator is a
    #: phone-bigram graph over the lexicon (ref: the sequence-
    #: discriminative training of RASR/NN; train/nn_trainer.py docs)
    corpus_file = ParameterString("corpus-file", default="")
    lexicon_file = ParameterString("lexicon-file", default="")
    states_per_phone = ParameterInt("states-per-phone", default=3)
    init_params_file = ParameterString("init-params-file", default="")
    mmi_ce_weight = ParameterFloat("mmi-ce-weight", default=0.1)
    #: sMBR accuracy unit: per tied state, or MPE-style per phone
    smbr_accuracy = ParameterChoice(
        "smbr-accuracy", ["state", "phone"], default="state"
    )

    def _sequence_mmi(self) -> int:
        import math

        from ..align.graph import build_linear_graph
        from ..corpus.bliss import CorpusDescription
        from ..corpus.lexicon import Lexicon
        from ..models.hmm import HmmTopology, TransitionModel
        from ..models.nn import BlstmEncoderNet, ConformerEncoderNet
        from ..models.tying import MonophoneStateTying
        from ..train.lfmmi import build_phone_bigram_den
        from ..train.nn_trainer import LfMmiSequenceTrainer

        corpus = CorpusDescription.load(self.corpus_file)
        lexicon = Lexicon.load(self.lexicon_file)
        topology = HmmTopology(states_per_phone=self.states_per_phone)
        tying = MonophoneStateTying(lexicon, topology)
        transitions = TransitionModel()
        dev = self.torch_device
        num_classes = self.num_classes or tying.num_classes
        orths = {s.full_name: s.orth for s in corpus.segments()}
        rows, labs, graphs = [], {}, []
        align = None
        if self.alignment_cache:
            align = FileArchive(self.alignment_cache, "r")
        with FileArchive(self.feature_cache, "r") as fc:
            for name in fc.keys():
                if name not in orths or not orths[name]:
                    continue
                rows.append(unpack_ndarray(fc.read(name)))
                graphs.append(
                    build_linear_graph(
                        orths[name], lexicon, tying, topology, transitions
                    )
                )
                if align is not None and name in align:
                    labs[len(rows) - 1] = Alignment.unpack(
                        name, align.read(name)
                    ).emission_ids
        if align is not None:
            align.close()
        if not rows:
            raise ValueError("no cached segments with orthography")
        Tmax = max(r.shape[0] for r in rows)
        feats = np.zeros((len(rows), Tmax, rows[0].shape[1]), np.float32)
        labels = np.full((len(rows), Tmax), -1, np.int32)
        n_frames = np.zeros(len(rows), np.int32)
        for i, r in enumerate(rows):
            feats[i, : r.shape[0]] = r
            n_frames[i] = r.shape[0]
            if i in labs:
                n = min(r.shape[0], labs[i].shape[0])
                labels[i, :n] = labs[i][:n]

        # denominator: phone bigram over the full phoneme inventory,
        # uniform bigram costs (the standard LF-MMI den-graph shape);
        # context-independent phones (silence) keep their own shorter
        # state chains so den minimum durations match the numerator
        phones = list(lexicon.phonemes)
        P, Q = len(phones), topology.states_per_phone
        states_of = [
            topology.silence_states if ph.context_independent else Q
            for ph in phones
        ]

        def classify(p, q):
            return tying._offset[phones[p].id] + min(q, states_of[p] - 1)

        den = build_phone_bigram_den(
            P, Q, classify,
            bigram_costs=np.full((P, P), math.log(P), np.float32),
            trans=transitions, states_of=states_of, device=dev,
        )
        if self.model_type == "ffnn":
            raise ValueError(
                "sequence-mmi-training needs a sequence encoder: "
                "set --model-type=blstm or conformer"
            )
        if self.model_type == "conformer":
            model = ConformerEncoderNet(
                num_classes=num_classes, in_dim=feats.shape[-1],
                d_model=self.hidden[0] if self.hidden else 256,
                num_blocks=max(len(self.hidden), 1),
                compute_dtype=self.compute_dtype, device=dev,
            )
        else:
            model = BlstmEncoderNet(
                num_classes=num_classes, in_dim=feats.shape[-1], hidden=tuple(self.hidden),
                compute_dtype=self.compute_dtype, device=dev,
            )
        criterion = (
            "smbr" if self.action == "sequence-smbr-training" else "mmi"
        )
        if criterion == "smbr" and not labs:
            raise ValueError(
                "sequence-smbr-training needs per-frame reference labels: "
                "set --alignment-cache to a forced-alignment cache"
            )
        if criterion == "smbr" and len(labs) < len(rows):
            # segments missing from the alignment cache would carry all
            # -1 labels: zero sMBR gradient, dead batch slots
            missing = len(rows) - len(labs)
            self.warning(
                f"{missing}/{len(rows)} segments have no alignment entry "
                f"and contribute no sMBR training signal"
            )
        class_map = None
        if criterion == "smbr" and self.smbr_accuracy == "phone":
            # phone id per tied class (MPE-style phone accuracy). The map
            # is indexed by the TYING's class ids; an overriding
            # --num-classes would silently alias tail classes to phone 0
            # (or clamp OOB in JAX), so reject the mismatch outright.
            if num_classes != tying.num_classes:
                raise ValueError(
                    f"--smbr-accuracy=phone needs --num-classes to match "
                    f"the tying inventory ({tying.num_classes}), "
                    f"got {num_classes}"
                )
            class_map = np.zeros(tying.num_classes, np.int32)
            for p in range(P):
                o = tying._offset[phones[p].id]
                class_map[o : o + states_of[p]] = p
        trainer = LfMmiSequenceTrainer(
            model, num_classes, den,
            TrainConfig(
                learning_rate=self.learning_rate, l2=self.l2,
                optimizer=self.optimizer, epochs=self.epochs, seed=self.seed,
            ),
            ce_weight=self.mmi_ce_weight if labs else 0.0,
            criterion=criterion, class_map=class_map,
        )
        params = None
        if self.init_params_file:
            params = NnTrainer.load_params(self.init_params_file, map_location=dev)
        params, stats = trainer.train_lfmmi(
            feats, graphs, n_frames, labels=labels, params=params,
            log=self.log, batch_size=min(self.batch_size, feats.shape[0]),
        )
        trainer.save_params(params, self.params_file)
        self.log(f"sequence {criterion} done",
                 final=stats[-1] if stats else {})
        return 0

    def run(self, args: List[str]) -> int:
        if self.action in ("sequence-mmi-training", "sequence-smbr-training"):
            return self._sequence_mmi()
        dev = self.torch_device
        feats, labels, weights = _load_frames(self.feature_cache, self.alignment_cache)
        ds = FrameDataset(feats, labels, weights)
        if not self.num_classes:
            # infer the tied-state inventory from the alignment labels
            # (the reference takes it from the mixture set)
            self.num_classes = int(labels.max()) + 1
        model = FeedForwardNet(
            num_classes=self.num_classes, in_dim=feats.shape[-1], hidden=tuple(self.hidden),
            activation=self.activation, compute_dtype=self.compute_dtype, device=dev,
        )
        trainer = NnTrainer(
            model, self.num_classes,
            TrainConfig(
                batch_size=self.batch_size, learning_rate=self.learning_rate,
                l2=self.l2, optimizer=self.optimizer, epochs=self.epochs,
                seed=self.seed,
            ),
        )
        if self.action == "estimate-priors":
            priors = trainer.estimate_priors(ds)
            priors.save(self.priors_file)
            self.log("priors estimated", classes=self.num_classes)
            return 0
        ckpt = None
        if self.checkpoint_dir:
            from ..train.checkpoint import CheckpointManager

            ckpt = CheckpointManager(self.checkpoint_dir)
        if self.model_type in ("blstm", "conformer"):
            from ..models.nn import BlstmEncoderNet, ConformerEncoderNet
            from ..train.nn_trainer import SequenceTrainer

            seq_feats, seq_labels = _load_sequences(
                self.feature_cache, self.alignment_cache
            )
            if self.model_type == "conformer":
                model = ConformerEncoderNet(
                    num_classes=self.num_classes, in_dim=seq_feats.shape[-1],
                    d_model=self.hidden[0] if self.hidden else 256,
                    num_blocks=max(len(self.hidden), 1),
                    compute_dtype=self.compute_dtype, device=dev,
                )
            else:
                model = BlstmEncoderNet(
                    num_classes=self.num_classes, in_dim=seq_feats.shape[-1],
                    hidden=tuple(self.hidden), compute_dtype=self.compute_dtype, device=dev,
                )
            strainer = SequenceTrainer(
                model, self.num_classes,
                TrainConfig(
                    learning_rate=self.learning_rate, l2=self.l2,
                    optimizer=self.optimizer, epochs=self.epochs,
                    seed=self.seed,
                ),
            )
            params, stats = strainer.train_sequences(
                seq_feats, seq_labels, log=self.log,
                batch_size=min(self.batch_size, seq_feats.shape[0]),
            )
        else:
            params, stats = trainer.train(
                ds, log=self.log, ckpt=ckpt,
                ckpt_every=self.checkpoint_every, resume=bool(self.resume),
            )
        trainer.save_params(params, self.params_file)
        priors = trainer.estimate_priors(ds)
        priors.save(self.priors_file)
        self.log("training done", final=stats[-1] if stats else {})
        return 0


if __name__ == "__main__":
    raise SystemExit(NnTrainerTool.main())
