"""Carry the JAX package's compiled state across to the port.

Each function takes a ``rasr_tpu`` object, reads its arrays as numpy
(``np.asarray(field)``) and builds the port's counterpart on ``device``.
Nothing here imports jax: the functions only read attributes, so they
accept the JAX objects directly. (The LDA matrix needs no converter:
``FeatureFrontend`` takes it as a numpy array.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.gmm import ScoringTensors
from .models.lm.ngram import NgramTables
from .ops.frontend import FrontendParams
from .search.decoder import TreeTables

def _tensor(x, device, index: bool = False) -> torch.Tensor:
    a = np.array(x)  # a writable host copy of the (read-only) JAX buffer
    t = torch.as_tensor(a, device=device)
    return t.to(torch.int64) if index and a.dtype.kind != "f" else t


def frontend_params_from_jax(params, device="cpu") -> FrontendParams:
    """``rasr_tpu.ops.frontend.FrontendParams`` -> the port's."""
    return FrontendParams(*(
        _tensor(getattr(params, f.name), device)
        for f in dataclasses.fields(FrontendParams)
    ))


def scoring_tensors_from_jax(st, device="cpu") -> ScoringTensors:
    """``rasr_tpu.models.gmm.ScoringTensors`` -> the port's (same
    ``[D, M*K]`` m-major layout)."""
    return ScoringTensors(
        a=_tensor(st.a, device), b=_tensor(st.b, device), c=_tensor(st.c, device),
        num_mixtures=int(st.num_mixtures), max_densities=int(st.max_densities),
    )


def ngram_tables_from_jax(tables, device="cpu") -> NgramTables:
    """``rasr_tpu.models.lm.ngram_tpu.NgramTables`` -> the port's (same
    bucketed hash table, bit for bit)."""
    fields = {}
    for f in dataclasses.fields(NgramTables):
        v = getattr(tables, f.name)
        fields[f.name] = int(v) if f.type in ("int", int) else _tensor(v, device)
    return NgramTables(**fields)


def tree_tables_from_jax(tables, device="cpu") -> TreeTables:
    """``rasr_tpu.search.decoder.TreeTables`` -> the port's (index
    columns widen to int64)."""
    fields = {}
    for f in dataclasses.fields(TreeTables):
        v = getattr(tables, f.name)
        if f.type in ("int", int):
            fields[f.name] = int(v)
        elif f.type in ("bool", bool):
            fields[f.name] = bool(v)
        else:
            fields[f.name] = _tensor(v, device, index=True)
    return TreeTables(**fields)
