"""The system under test, drawn from a seed and built by the port's builders.

:func:`draw` makes every input the recognizer is built from (the lexicon,
the LM, the GMM parameters or the conformer's priors, the LDA) as plain
Python and numpy data from ``--seed``; it follows the draws of the port's
``synthetic.build_setup`` (itself the reference benchmark's
``bench.py:35-276``), vectorised where that copy looped. The plain
reference reads the same data; only :func:`build` hands it to the port.
The conformer's weights are drawn on the card (:func:`draw_conformer`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Draws:
    """Everything the system is built from, as plain data."""

    phones: List[str]  # speech phone symbols; the silence phone is "si"
    words: List[Tuple[str, List[str]]]  # (orth, pronunciation) in lexicon order
    vocab: Dict[str, int]  # LM word ids
    ngrams: Dict[Tuple[int, ...], Tuple[float, float]]  # -> (-log p, -log backoff)
    lda: np.ndarray  # [lda_in, feat_dim]
    gmm: Optional[Dict[str, np.ndarray]] = None  # means, variances, weights [M, K(, D)]
    prior_counts: Optional[np.ndarray] = None  # [M], the conformer's class counts


def draw(cfg: dict, seed: int) -> Draws:
    """The configuration's lexicon, LM, acoustic parameters and LDA from
    ``seed``."""
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
    out = Draws(phones, words, vocab, ngrams, lda=None)
    if cfg["scorer"] == "gmm":
        K = cfg["gmm"]["densities"]
        out.gmm = {
            "means": rng.normal(size=(M, K, D)).astype(np.float32),
            "variances": (0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
            "weights": np.full((M, K), 1.0 / K, np.float32),
        }
    else:
        out.prior_counts = rng.uniform(*cfg["conformer"]["prior_counts"], size=M).astype(
            np.float32)
    out.lda = (rng.normal(size=(cfg["frontend"]["lda_in"], D)) * 0.1).astype(np.float32)
    return out


# ------------------------------------------------------------------ conformer
def conformer_param_specs(cfg: dict, in_dim: int, classes: int):
    """``(name, shape, init)`` of every conformer parameter, named as the
    port's ``ConformerEncoderNet`` state dict names them. ``init`` is
    ``("lecun", fan_in)``, ``"zeros"`` or ``"ones"`` (flax's initializers)."""
    c = cfg["conformer"]
    d, ff, k = c["d_model"], c["d_model"] * c["ff_mult"], c["conv_kernel"]
    specs = []

    def linear(name, n_in, n_out):
        specs.append((f"{name}.weight", (n_out, n_in), ("lecun", n_in)))
        specs.append((f"{name}.bias", (n_out,), "zeros"))

    def ln(name):
        specs.append((f"{name}.weight", (d,), "ones"))
        specs.append((f"{name}.bias", (d,), "zeros"))

    linear("input_proj", in_dim, d)
    for i in range(c["num_blocks"]):
        p = f"block.{i}."
        ln(p + "ff1_ln"), ln(p + "ff2_ln")
        linear(p + "ff1_in", d, ff), linear(p + "ff2_in", d, ff)
        linear(p + "ff1_out", ff, d), linear(p + "ff2_out", ff, d)
        ln(p + "mhsa_ln")
        for proj in ("query", "key", "value", "out"):
            linear(p + "mhsa." + proj, d, d)
        ln(p + "conv_ln")
        linear(p + "conv_in", d, 2 * d)
        specs.append((p + "conv_dw.weight", (d, 1, k), ("lecun", k)))
        specs.append((p + "conv_dw.bias", (d,), "zeros"))
        ln(p + "conv_bn")
        linear(p + "conv_out", d, d)
        ln(p + "final_ln")
    linear("output", d, classes)
    return specs


def draw_conformer(cfg: dict, in_dim: int, classes: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The conformer's float32 weights, drawn on ``device`` from ``seed`` in
    one call: lecun-normal kernels (normal truncated to two deviations,
    by the inverse CDF of one uniform draw), zero biases, unit LayerNorm
    scales."""
    specs = conformer_param_specs(cfg, in_dim, classes)
    sizes = [math.prod(s) for _, s, init in specs if isinstance(init, tuple)]
    gen = torch.Generator(device=device).manual_seed(seed)
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(sum(sizes), generator=gen, device=device) * (hi - lo) + lo
    z = torch.erfinv(2.0 * u - 1.0).mul_(math.sqrt(2.0))
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            std = math.sqrt(1.0 / init[1]) / 0.87962566103423978
            out[name] = (z[at:at + n] * std).view(shape)
            at += n
    return out


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


def build(cfg: dict, d: Draws, device, weights: Optional[Dict[str, torch.Tensor]] = None,
          decoder: bool = True) -> System:
    """The recognizer from the draws, by the port's own builders: the
    prefix tree with its unigram lookahead, the compiled LM, the frontend,
    and the GMM or conformer scorer."""
    from rasr_tpu_torch.models.gmm import MixtureSet
    from rasr_tpu_torch.models.lm.arpa import NgramLm
    from rasr_tpu_torch.models.lm.ngram import compile_ngram
    from rasr_tpu_torch.models.nn import ConformerEncoderNet, NnHybridScorer, StatePriors
    from rasr_tpu_torch.models.scorer import GmmFeatureScorer
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
    M = cfg["tying"]["num_classes"]
    if cfg["scorer"] == "gmm":
        g = cfg["gmm"]
        K = g["densities"]
        ms = MixtureSet(means=d.gmm["means"], variances=d.gmm["variances"],
                        weights=d.gmm["weights"], num_densities=np.full(M, K, np.int32))
        scorer = GmmFeatureScorer(ms, scale=g["scale"], max_approx=True,
                                  var_floor=g["var_floor"], device=device)
    else:
        c = cfg["conformer"]
        net = ConformerEncoderNet(M, f["feat_dim"], d_model=c["d_model"],
                                  num_blocks=c["num_blocks"], num_heads=c["num_heads"],
                                  ff_mult=c["ff_mult"], conv_kernel=c["conv_kernel"],
                                  compute_dtype=c["compute_dtype"], device=device)
        with torch.no_grad():
            net.load_state_dict(weights, strict=True)
        scorer = NnHybridScorer(net, None, StatePriors.from_counts(d.prior_counts),
                                scale=c["scale"], prior_scale=c["prior_scale"], device=device)
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
