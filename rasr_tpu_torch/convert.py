"""Carry the JAX package's compiled state across to the port.

Each function takes a ``rasr_tpu`` object, reads its arrays as numpy
(``np.asarray(field)``) and builds the port's counterpart on ``device``
(the card when it is None); the host-side ones (``MixtureSet``,
``LinearGraph``) stay numpy. Nothing here imports jax: the functions
only read attributes, so they accept the JAX objects directly. (The LDA
matrix needs no converter: ``FeatureFrontend`` takes it as a numpy
array.) ``nn_params_from_flax`` turns a flax parameter tree into a
``state_dict`` for one of the port's networks, ``rnn_lm_from_flax`` the
JAX ``RnnLm`` into the port's.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
from torch import nn

from .align.graph import LinearGraph
from .corpus.lexicon import Lemma, Pronunciation
from .device import resolve
from .models.allophone import Allophone, AllophoneState
from .models.gmm import MixtureSet, ScoringTensors
from .models.lm.ngram import NgramTables
from .models.lm.rnn import LstmLm, RnnLm
from .ops.frontend import FrontendParams
from .search.decoder import BigramTables, TreeTables
from .search.rnn_fusion import RnnFusionTables
from .train.lfmmi import DenseFsa


def _tensor(x, device, index: bool = False) -> torch.Tensor:
    a = np.array(x)  # a writable host copy of the (read-only) JAX buffer
    t = torch.as_tensor(a, device=resolve(device))
    return t.to(torch.int64) if index and a.dtype.kind != "f" else t


def frontend_params_from_jax(params, device=None) -> FrontendParams:
    """``rasr_tpu.ops.frontend.FrontendParams`` -> the port's."""
    return FrontendParams(*(
        _tensor(getattr(params, f.name), device)
        for f in dataclasses.fields(FrontendParams)
    ))


def scoring_tensors_from_jax(st, device=None) -> ScoringTensors:
    """``rasr_tpu.models.gmm.ScoringTensors`` -> the port's (same
    ``[D, M*K]`` m-major layout)."""
    return ScoringTensors(
        a=_tensor(st.a, device), b=_tensor(st.b, device), c=_tensor(st.c, device),
        num_mixtures=int(st.num_mixtures), max_densities=int(st.max_densities),
    )


def mixture_set_from_jax(ms) -> MixtureSet:
    """``rasr_tpu.models.gmm.MixtureSet`` -> the port's (numpy fields)."""
    return MixtureSet(*(np.array(getattr(ms, f.name))
                        for f in dataclasses.fields(MixtureSet)))


def dense_fsa_from_jax(fsa, device=None) -> DenseFsa:
    """``rasr_tpu.train.lfmmi.DenseFsa`` -> the port's (emission classes
    as int64)."""
    return DenseFsa(_tensor(fsa.trans, device), _tensor(fsa.emis_class, device, index=True),
                    _tensor(fsa.init, device), _tensor(fsa.final, device))


def linear_graph_from_jax(g) -> LinearGraph:
    """``rasr_tpu.align.graph.LinearGraph`` -> the port's (its allophone
    states and lemmata rebuilt field by field)."""
    states = [AllophoneState(Allophone(s.allophone.center, s.allophone.left,
                                       s.allophone.right, s.allophone.boundary), s.state)
              for s in g.states]
    lemmas = [Lemma(l.id, list(l.orth), [Pronunciation(tuple(p.phonemes), p.score)
                                         for p in l.pronunciations],
                    l.special, l.synt, l.evals) for l in g.lemmas]
    arrays = {f: np.array(getattr(g, f)) for f in
              ("emission_ids", "loop", "fwd", "skip", "init", "final", "lemma_of_state")}
    return LinearGraph(states=states, lemmas=lemmas, **arrays)


def ngram_tables_from_jax(tables, device=None) -> NgramTables:
    """``rasr_tpu.models.lm.ngram_tpu.NgramTables`` -> the port's (same
    bucketed hash table, bit for bit)."""
    fields = {}
    for f in dataclasses.fields(NgramTables):
        v = getattr(tables, f.name)
        fields[f.name] = int(v) if f.type in ("int", int) else _tensor(v, device)
    return NgramTables(**fields)


def _tables_from_jax(cls, tables, device):
    """A JAX table pytree -> the port's dataclass ``cls`` of the same
    fields (index columns widen to int64; None stays None)."""
    fields = {}
    for f in dataclasses.fields(cls):
        v = getattr(tables, f.name)
        if f.type in ("int", int):
            fields[f.name] = int(v)
        elif f.type in ("bool", bool):
            fields[f.name] = bool(v)
        elif f.type in ("float", float):
            fields[f.name] = float(v)
        else:
            fields[f.name] = None if v is None else _tensor(v, device, index=True)
    return cls(**fields)


def tree_tables_from_jax(tables, device=None) -> TreeTables:
    """``rasr_tpu.search.decoder.TreeTables`` -> the port's (either
    network: the across-word one's ``we_next`` re-entries included)."""
    return _tables_from_jax(TreeTables, tables, device)


def bigram_tables_from_jax(tables, device=None) -> BigramTables:
    """``rasr_tpu.search.decoder.BigramTables`` -> the port's (pass it as
    ``TreeDecoder(bigram_la=...)`` to decode on the JAX decoder's own
    lookahead tables)."""
    return _tables_from_jax(BigramTables, tables, device)


def _flax_path(name: str):
    """A module name of the port's networks -> its flax scope path: a
    list index joins its list's name (``block.3.mhsa.query`` ->
    ``block3/mhsa/query``, ``hidden.0`` -> ``hidden0``)."""
    return re.sub(r"\.(\d+)", r"\1", name).split(".")


def nn_params_from_flax(model: nn.Module, params) -> dict:
    """The JAX package's flax parameter tree of one of the networks of
    ``rasr_tpu.models.nn`` (numpy or JAX arrays) -> a ``state_dict`` for
    the port's ``model`` of the same shape (``model.load_state_dict``).

    ``Dense`` kernels ``[in, out]`` become ``Linear.weight [out, in]``;
    the attention's ``query`` / ``key`` / ``value`` kernels ``[d, H, hd]``
    and biases ``[H, hd]`` flatten their heads, ``out`` ``[H, hd, d]``
    likewise; ``Conv`` kernels ``[k, in / groups, out]`` become
    ``[out, in / groups, k]``; LayerNorm ``scale`` becomes ``weight``.
    An LSTM layer i takes the cells ``OptimizedLSTMCell_{2i}`` (forward)
    and ``_{2i+1}`` (backward), flax's order of creation: the input
    kernels ``ii / if / ig / io`` (no bias) and the hidden ones
    ``hi / hf / hg / ho`` stack in torch's gate order i, f, g, o, with the
    hidden biases as ``bias_hh`` and ``bias_ih`` zero."""

    def host(x):
        return torch.from_numpy(np.array(x, np.float32))

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.LSTM):
            for direction, suffix in enumerate(("", "_reverse")):
                layer = int(name.rsplit(".", 1)[1])
                cell = params[f"OptimizedLSTMCell_{2 * layer + direction}"]
                w_ih = torch.cat([host(cell[f"i{g}"]["kernel"]).T for g in "ifgo"])
                w_hh = torch.cat([host(cell[f"h{g}"]["kernel"]).T for g in "ifgo"])
                b_hh = torch.cat([host(cell[f"h{g}"]["bias"]) for g in "ifgo"])
                out.update({f"{name}.weight_ih_l0{suffix}": w_ih,
                            f"{name}.weight_hh_l0{suffix}": w_hh,
                            f"{name}.bias_ih_l0{suffix}": torch.zeros_like(b_hh),
                            f"{name}.bias_hh_l0{suffix}": b_hh})
            continue
        if not isinstance(mod, (nn.Linear, nn.Conv1d, nn.LayerNorm)):
            continue
        tree = params
        for key in _flax_path(name):
            tree = tree[key]
        if isinstance(mod, nn.Linear):
            weight = host(tree["kernel"]).reshape(mod.in_features, mod.out_features).T
        elif isinstance(mod, nn.Conv1d):
            weight = host(tree["kernel"]).permute(2, 1, 0)
        else:
            weight = host(tree["scale"])
        out[f"{name}.weight"] = weight.contiguous()
        out[f"{name}.bias"] = host(tree["bias"]).reshape(-1)
    return out


def lstm_lm_params_from_flax(params) -> dict:
    """The flax ``LstmLmModule``'s parameter tree -> a ``state_dict`` for
    :class:`~.models.lm.rnn.LstmLm`: the cell's kernels concatenated in
    gate order i, f, g, o, ``proj``'s kernel transposed."""

    def host(x):
        return torch.from_numpy(np.array(x, np.float32))

    lstm = params["lstm"]
    return {
        "embed.weight": host(params["embed"]["embedding"]),
        "wx": torch.cat([host(lstm[f"i{g}"]["kernel"]) for g in "ifgo"], dim=1),
        "wh": torch.cat([host(lstm[f"h{g}"]["kernel"]) for g in "ifgo"], dim=1),
        "b": torch.cat([host(lstm[f"h{g}"]["bias"]) for g in "ifgo"]),
        "proj.weight": host(params["proj"]["kernel"]).T.contiguous(),
        "proj.bias": host(params["proj"]["bias"]),
    }


def rnn_lm_from_flax(rnn_lm, device=None) -> RnnLm:
    """``rasr_tpu.models.lm.rnn.RnnLm`` (its flax parameters, vocabulary
    and dimensions) -> the port's ``RnnLm`` on ``device``."""
    m = rnn_lm.module
    model = LstmLm(int(m.vocab_size), int(m.embed_dim), int(m.hidden_dim))
    model.load_state_dict(lstm_lm_params_from_flax(rnn_lm.params))
    return RnnLm(model, rnn_lm.vocab, cache_size=rnn_lm._cache_size, device=device)


def rnn_fusion_tables_from_jax(tables, device=None) -> RnnFusionTables:
    """``rasr_tpu.search.rnn_fusion.RnnFusionTables`` -> the port's (pass
    it as ``TreeDecoder(rnn_fusion=...)``)."""
    return _tables_from_jax(RnnFusionTables, tables, device)
