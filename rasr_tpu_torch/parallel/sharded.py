"""Sharded compute: TP GMM scoring, DP EM and fMLLR statistics, DP decode,
tensor-parallel conformer.

Counterpart of ``rasr_tpu/parallel/sharded.py`` on a ``DeviceMesh``
(``parallel/mesh.py``), one process per rank:

* **GMM inventory sharding (TP)**: the mixtures pad to a multiple of the
  ``model`` axis (padded densities at ``c = 1e30``); each ``model`` rank
  scores its block of mixtures through the GMM kernel
  (``ops/kernels/gmm.py::gmm_scores``, min or LSE), and the blocks come
  together with one ``all_gather`` over ``model``;
* **EM and fMLLR statistics (DP)**: each ``data`` rank accumulates its
  share of the frames; the statistics reduce with ``all_reduce`` (the
  reference's combine-accumulators action);
* **counters**: summed over ``data``;
* **DP decode**: ``TreeDecoder.decode_scores(mesh=...)``;
* **conformer TP**: ``parallelize_module`` with the reference's split
  axes (heads, FF and conv column-split in and row-split out, depthwise
  channels).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.parallel import (
    ColwiseParallel, RowwiseParallel, parallelize_module,
)

from ..models.gmm import MixtureSet, ScoringTensors, make_scoring_tensors
from ..ops.kernels.gmm import gmm_scores
from ..train.em import GmmAccumulator, accumulate
from ..train.fmllr import FmllrModelTensors, fmllr_stats
from .mesh import (
    all_gather, all_reduce, axis_index, axis_size, data_rows, mesh_device, shard_batch,
)

#: ``c`` of the padding densities of the last mixture block
PAD_C = 1e30


class ShardedGmmScorer:
    """GMM scorer with the density inventory sharded over ``model``.

    Every rank passes the full ``[B, T, D]`` batch; the rank scores its
    ``data`` shard (:func:`~.mesh.data_rows`) against its block of
    mixtures with the GMM kernel, and returns its shard's ``[B_loc, T, M]``
    scores assembled over ``model``."""

    def __init__(self, mixtures: MixtureSet, mesh: DeviceMesh, scale: float = 1.0,
                 max_approx: bool = True, var_floor: float = 1e-4):
        self.mesh = mesh
        self.scale = scale
        self.max_approx = max_approx
        self.num_classes = mixtures.num_mixtures
        st = make_scoring_tensors(mixtures, var_floor, device="cpu")
        self.M, self.K = st.num_mixtures, st.max_densities
        P = axis_size(mesh, "model")
        Mb = -(-self.M // P)  # mixtures per block
        pad = (Mb * P - self.M) * self.K
        a = torch.nn.functional.pad(st.a, (0, pad))
        b = torch.nn.functional.pad(st.b, (0, pad))
        c = torch.nn.functional.pad(st.c, (0, pad), value=PAD_C)
        cols = slice(axis_index(mesh, "model") * Mb * self.K,
                     (axis_index(mesh, "model") + 1) * Mb * self.K)
        self.block = ScoringTensors(a[:, cols].contiguous(), b[:, cols].contiguous(),
                                    c[cols].contiguous(), Mb, self.K).to(mesh_device(mesh))

    def score(self, feats) -> torch.Tensor:
        x = shard_batch(self.mesh, torch.as_tensor(feats, dtype=torch.float32))
        part = gmm_scores(x.contiguous(), self.block, self.max_approx)
        return self.scale * all_gather(part, self.mesh, "model", dim=-1)[..., : self.M]

    __call__ = score


def _reduce_host(arrays, mesh: DeviceMesh):
    """float64 host arrays summed over ``data`` (on the mesh's device)."""
    dev = mesh_device(mesh)
    return tuple(all_reduce(torch.as_tensor(a, dtype=torch.float64, device=dev), mesh,
                            "data").cpu().numpy() for a in arrays)


def dp_accumulate(mesh: DeviceMesh, model: MixtureSet, feats, labels, weights=None,
                  var_floor: float = 1e-4):
    """One data-parallel EM accumulation over ``[N, D]`` frames with labels
    (-1 = padding): each data rank takes its share of the frames
    (``train/em.py::accumulate``), the statistics sum over ``data``.
    Returns host float64 ``(count, sum, sumsq)``."""
    rows = data_rows(mesh, len(labels))
    acc = GmmAccumulator.zeros(*model.means.shape)
    if rows.stop > rows.start:
        w = None if weights is None else torch.as_tensor(weights)[rows]
        accumulate(acc, model, torch.as_tensor(feats)[rows].to(mesh_device(mesh)),
                   torch.as_tensor(labels)[rows], w, var_floor)
    return _reduce_host((acc.count, acc.sum, acc.sumsq), mesh)


def psum_counters(mesh: DeviceMesh, values) -> np.ndarray:
    """Per-rank counter rows ``[n, ...]`` (WER counts, ...) summed over
    ``data``: the collective in place of merging per-job logs."""
    return _reduce_host((np.asarray(values, np.float64).sum(axis=0),), mesh)[0]


def dp_decode(decoder, mesh: DeviceMesh, emissions, n_frames, names=None):
    """Data-parallel beam decode: each data rank decodes its share of the
    utterances, the results assemble over ``data``
    (``TreeDecoder.decode_scores(mesh=...)``)."""
    return decoder.decode_scores(emissions, n_frames, names=names, mesh=mesh)


def dp_fmllr_stats(mesh: DeviceMesh, model: MixtureSet, feats, mix_ids,
                   var_floor: float = 1e-4):
    """Data-parallel fMLLR statistics (``train/fmllr.py::fmllr_stats``)
    over ``[N, D]`` frames aligned to mixtures, summed over ``data``:
    ``(G, k, beta)``."""
    dev = mesh_device(mesh)
    rows = data_rows(mesh, len(mix_ids))
    D = model.dim
    G, k, beta = np.zeros((D, D + 1, D + 1)), np.zeros((D, D + 1)), 0.0
    if rows.stop > rows.start:
        mt = FmllrModelTensors.from_mixture_set(model, var_floor, dev)
        G, k, beta = fmllr_stats(torch.as_tensor(feats)[rows].to(dev),
                                 np.asarray(mix_ids)[rows], mt)
    G, k, beta = _reduce_host((G, k, np.array([beta])), mesh)
    return G, k, float(beta[0])


# ------------------------------------------------- NN tensor parallelism
COL_IN = ("ff1_in", "ff2_in", "conv_in")  # [4d, d]-style torch weights: row (output) split
ROW_OUT = ("ff1_out", "ff2_out", "conv_out")  # [d, 4d]: column (input) split


def conformer_param_specs(net: nn.Module) -> dict:
    """Placement over ``model`` of every parameter of a
    ``models.nn.ConformerEncoderNet``, by name (the reference's
    ``conformer_param_specs`` in torch's ``[out, in]`` layout): attention
    heads (``query`` / ``key`` / ``value`` output rows, ``out`` input
    columns), the FF and conv pointwise expansions split on their output
    on the way in (``Shard(0)``, biases too) and on their input on the way
    out (``Shard(1)``), the depthwise channels (``conv_dw``); everything
    else (LayerNorms, projections, biases of the row-split layers)
    ``Replicate()``."""
    specs = {}
    for name, _ in net.named_parameters():
        parts = name.split(".")
        layer, kind = parts[-2], parts[-1]
        s = Replicate()
        if layer in ("query", "key", "value") or layer in COL_IN or layer == "conv_dw":
            s = Shard(0)
        elif (layer == "out" and "mhsa" in parts or layer in ROW_OUT) and kind == "weight":
            s = Shard(1)
        specs[name] = s
    return specs


class _GatherChannels(nn.Module):
    """A LayerNorm over every channel in front of which each ``model`` rank
    holds its slice of the channels: the slices are gathered first."""

    def __init__(self, norm: nn.LayerNorm, mesh: DeviceMesh):
        super().__init__()
        self.norm, self.mesh = norm, mesh

    def forward(self, h):
        return self.norm(all_gather(h, self.mesh, "model", dim=-1))


def shard_conformer_params(net: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Tensor-parallel ``ConformerEncoderNet`` over ``model`` (in place):
    ``parallelize_module`` with :func:`conformer_param_specs`' split axes,
    Megatron style (column-split layers keep their local output, row-split
    layers all-reduce theirs). The conv module's GLU pairs channel c with
    channel d + c, so ``conv_in``'s output rows are laid out rank by rank
    as (its slice of the first half, the same slice of the second half)
    before the split; the depthwise conv keeps this rank's channels; the
    LayerNorm behind it (``conv_bn``) gathers the channels, and
    ``conv_out`` takes its input replicated. Same maths as the replicated
    network up to float32 reduction order; float32 compute only."""
    P, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    tp = mesh["model"]
    for block in net.block:
        d = block.conv_dw.in_channels
        if d % P or block.mhsa.num_heads % P:
            raise ValueError(f"d_model {d} / {block.mhsa.num_heads} heads do not split "
                             f"over {P} ranks")
        c = d // P
        with torch.no_grad():
            halves = torch.arange(2 * d).reshape(2, P, c).permute(1, 0, 2).reshape(-1)
            block.conv_in.weight.copy_(block.conv_in.weight[halves])
            block.conv_in.bias.copy_(block.conv_in.bias[halves])
            dw = block.conv_dw
            local = nn.Conv1d(c, c, dw.kernel_size[0], padding="same", groups=c,
                              device=dw.weight.device)
            local.weight.copy_(dw.weight[r * c:(r + 1) * c])
            local.bias.copy_(dw.bias[r * c:(r + 1) * c])
        block.conv_dw = local
        block.conv_bn = _GatherChannels(block.conv_bn, mesh)
        plan = {name: ColwiseParallel() for name in ("ff1_in", "ff2_in", "conv_in",
                                                      "mhsa.query", "mhsa.key", "mhsa.value")}
        plan.update({name: RowwiseParallel() for name in ("ff1_out", "ff2_out", "mhsa.out")})
        plan["conv_out"] = RowwiseParallel(input_layouts=Replicate())
        parallelize_module(block, tp, plan)
    return net
