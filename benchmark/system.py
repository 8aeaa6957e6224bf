"""The system under test, drawn from a seed and built by the port's builders.

:func:`draw` makes every input the recognizer is built from (the lexicon,
the LM, the acoustic model's draws, the LDA) as plain Python and numpy
data from ``--seed``; it follows the draws of the port's
``synthetic.build_setup`` (itself the reference benchmark's
``bench.py:35-276``), vectorised where that copy looped. The plain
reference reads the same data; only :func:`build` hands it to the port.

The acoustic model is found by name, as the traffic's job and the
metrics' readers are: the configuration's ``"scorer"`` names a module of
``benchmark/models`` (``spec.model``), which draws the model's own data,
draws its weights on the device, builds the port's scorer (and network),
counts its work and holds its plain reference (its interface:
``benchmark/models/__init__.py``). This module keeps what every model
shares: the frontend, lexicon, tree, LM and decoder.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import spec


@dataclasses.dataclass
class Draws:
    """Everything the system is built from, as plain data."""

    phones: List[str]  # speech phone symbols; the silence phone is "si"
    words: List[Tuple[str, List[str]]]  # (orth, pronunciation) in lexicon order
    vocab: Dict[str, int]  # LM word ids
    ngrams: Dict[Tuple[int, ...], Tuple[float, float]]  # -> (-log p, -log backoff)
    acoustic: Dict[str, np.ndarray]  # the model's draws (benchmark/models/<scorer>.py::draw)
    lda: np.ndarray  # [lda_in, feat_dim]


def draw(cfg: dict, seed: int) -> Draws:
    """The configuration's lexicon, LM, acoustic model's draws and LDA
    from ``seed``."""
    rng = np.random.default_rng(seed)
    lx, lm = cfg["lexicon"], cfg["lm"]
    phones = [f"p{i}" for i in range(lx["num_phones"])]
    lo, hi = lx["pron_len"]
    words, seen = [], set()
    for w in range(lx["num_words"]):
        pron = tuple(rng.choice(phones, size=int(rng.integers(lo, hi))))
        if pron in seen:
            continue
        seen.add(pron)
        words.append((f"w{w}", list(pron)))
    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2}
    for orth, _ in words:
        vocab.setdefault(orth, len(vocab))
    n = len(vocab)
    uni = rng.uniform(*lm["unigram_cost"], size=n)
    bo = rng.uniform(*lm["backoff_cost"], size=n)
    ngrams = {(i,): (float(uni[i]), float(bo[i])) for i in range(n)}
    pairs = lx["num_words"] * lm["bigrams_per_word"]
    a, b = rng.integers(0, n, size=pairs), rng.integers(0, n, size=pairs)
    cost = rng.uniform(*lm["bigram_cost"], size=pairs)
    for x, y, c in zip(a.tolist(), b.tolist(), cost.tolist()):
        ngrams[(x, y)] = (c, 0.0)
    M = cfg["tying"]["num_classes"]
    D = cfg["frontend"]["feat_dim"]
    # the model's draws come from the same generator between the LM's and the
    # LDA's, as they did when this function drew each model itself: every
    # cell's data stays bit-identical for the same seed
    acoustic = spec.model(cfg).draw(cfg, rng, M, D)
    lda = (rng.normal(size=(cfg["frontend"]["lda_in"], D)) * 0.1).astype(np.float32)
    return Draws(phones, words, vocab, ngrams, acoustic, lda)


# ---------------------------------------------------------------- the port
@dataclasses.dataclass
class System:
    frontend: object  # FeatureFrontend
    scorer: object  # FeatureScorer
    decoder: object  # TreeDecoder, or None


def beam_config(cfg: dict):
    from rasr_tpu_torch.search.decoder import BeamConfig

    return BeamConfig(beam=1e9, **cfg["beam"])


def port_lexicon(cfg: dict, d: Draws):
    """The port's lexicon, HMM topology, transition model and tying."""
    from rasr_tpu_torch.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu_torch.models.hmm import HmmTopology, Tdp, TransitionModel
    from rasr_tpu_torch.synthetic import HashTying

    lex = Lexicon()
    build_default_silence(lex)
    for p in d.phones:
        lex.phonemes.add(p)
    for orth, pron in d.words:
        lex.add_lemma([orth], [(list(pron), 0.0)])
    h = cfg["hmm"]

    def tdp(t):
        return Tdp(**{k: (math.inf if v is None else v) for k, v in t.items()})

    topo = HmmTopology(states_per_phone=h["states_per_phone"], silence_states=h["silence_states"])
    trans = TransitionModel(speech=tdp(h["speech_tdp"]), silence=tdp(h["silence_tdp"]))
    return lex, topo, trans, HashTying(cfg["tying"]["num_classes"])


def build(cfg: dict, d: Draws, device, weights: Optional[dict] = None,
          decoder: bool = True) -> System:
    """The recognizer from the draws, by the port's own builders: the
    prefix tree with its unigram lookahead, the compiled LM, the frontend,
    and the scorer of the configuration's model (with its ``weights``)."""
    from rasr_tpu_torch.models.lm.arpa import NgramLm
    from rasr_tpu_torch.models.lm.ngram import compile_ngram
    from rasr_tpu_torch.ops.frontend import FeatureFrontend, FrontendConfig
    from rasr_tpu_torch.search.decoder import TreeDecoder
    from rasr_tpu_torch.search.tree import build_prefix_tree
    from rasr_tpu_torch.synthetic import auto_branch_width

    f = cfg["frontend"]
    fcfg = FrontendConfig(
        sample_rate=cfg["sample_rate"], frame_length_ms=f["frame_length_ms"],
        frame_shift_ms=f["frame_shift_ms"], preemphasis=f["preemphasis"], window=f["window"],
        num_mel=f["num_mel"], num_cepstra=f["num_cepstra"], log_floor=f["log_floor"],
        normalize=f["normalize"])
    frontend = FeatureFrontend(fcfg, splice_context=f["splice_context"], lda=d.lda, device=device)
    scorer = spec.model(cfg).scorer(cfg, d, weights, device)
    if not decoder:
        return System(frontend, scorer, None)
    lex, topo, trans, tying = port_lexicon(cfg, d)
    lm = NgramLm(2, d.vocab, d.ngrams)
    unigrams = {wid: d.ngrams[(wid,)][0] for wid in d.vocab.values()}
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=d.vocab, lm_unigrams=unigrams,
                             skip_scope=cfg["hmm"]["skip_scope"])
    beam = beam_config(cfg)
    beam = dataclasses.replace(beam, branch_width=auto_branch_width(tree, beam))
    dec = TreeDecoder(tree, compile_ngram(lm), beam, device=device)
    return System(frontend, scorer, dec)
