"""Carry the JAX package's compiled state across to the port.

Each function takes a ``rasr_tpu`` object, reads its arrays as numpy
(``np.asarray(field)``) and builds the port's counterpart on ``device`` (the card when it is None).
Nothing here imports jax: the functions only read attributes, so they
accept the JAX objects directly. (The LDA matrix needs no converter:
``FeatureFrontend`` takes it as a numpy array.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve
from .models.gmm import ScoringTensors
from .models.lm.ngram import NgramTables
from .ops.frontend import FrontendParams
from .search.decoder import BigramTables, TreeTables

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
