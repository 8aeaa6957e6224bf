"""Process mesh, collectives and rank launch over ``torch.distributed``.

Counterpart of ``rasr_tpu/parallel/mesh.py``. The reference is one
controller over a ``jax.sharding.Mesh`` whose ``jit`` / ``shard_map``
insert the collectives; the port runs one process per rank (multi
controller) over a ``DeviceMesh`` with the same axes ``("data",
"model")``:

* utterance batches shard over ``data`` (DP: the reference's corpus
  partitioning, merged by ``all_reduce`` instead of accumulator files);
* the GMM density inventory, the NN hidden dims and the decoder's beam
  slots shard over ``model`` (TP).

Every rank calls a sharded function with the same full inputs; it
computes on its own shard (:func:`data_rows`) and the results are reduced
or gathered over a mesh axis, so every rank gets what one process would.
The collectives map one to one: ``psum`` -> :func:`all_reduce` (SUM),
``pmin`` -> :func:`all_reduce` (MIN), a tiled ``all_gather`` ->
:func:`all_gather` (``all_gather_into_tensor``), ``ppermute`` halos ->
an :func:`all_gather` of the edges. All work on NCCL and on gloo, with
CUDA or CPU tensors. The backend is always named by the caller:
``"nccl"`` for ranks on cards, ``"gloo"`` for CPU ranks (or several
ranks sharing one card).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..device import resolve

AXES = ("data", "model")
BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str, init_method: str, rank: int, world_size: int) -> None:
    """Join the process group (the reference's ``jax.distributed``
    bring-up). ``init_method`` is ``tcp://host:port`` or
    ``file:///path/store``; nothing picks the backend for the caller."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank of the process group; this
    rank computes on ``device`` (the card unless the caller names the
    CPU; over NCCL each rank names its own card). Collective on every
    rank."""
    device = resolve(device)
    world = dist.get_world_size()
    if data is None:
        data = world // model
    assert data * model == world, f"mesh {data}x{model} != {world} ranks"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return init_device_mesh(device.type, (data, model), mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh[axis].size()


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


# ------------------------------------------------------------------ shardings
def data_sharding(mesh: DeviceMesh):
    """Placements of ``[B, ...]`` utterance tensors: rows over ``data``."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh):
    return (Replicate(), Replicate())


def gmm_sharding(mesh: DeviceMesh):
    """Placements of the scoring tensors ``[D, M*K]``: the density axis
    (last) over ``model``."""
    return (Replicate(), Shard(1))


def data_rows(mesh: DeviceMesh, n: int) -> slice:
    """This rank's contiguous share of ``n`` rows: ``ceil(n / data)`` per
    data rank (the last ones may hold fewer, or none)."""
    per = -(-n // axis_size(mesh, "data"))
    lo = min(axis_index(mesh, "data") * per, n)
    return slice(lo, min(lo + per, n))


def shard_batch(mesh: DeviceMesh, *arrays):
    """This rank's data shard of each ``[B, ...]`` array, on its device."""
    dev = mesh_device(mesh)
    out = tuple(torch.as_tensor(a)[data_rows(mesh, len(a))].to(dev) for a in arrays)
    return out if len(out) > 1 else out[0]


# ---------------------------------------------------------------- collectives
_REDUCE = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, axis: str, op: str = "sum") -> torch.Tensor:
    """``psum`` / ``pmin`` / ``pmax`` of ``x`` over a mesh axis (a new tensor)."""
    out = x.clone().contiguous()
    dist.all_reduce(out, op=_REDUCE[op], group=mesh.get_group(axis))
    return out


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Tiled ``all_gather``: every rank's ``x`` along ``dim``, in the
    axis' rank order. Every rank's ``x`` must have one shape."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _gather_single(out, src, group=group)
    return out.movedim(0, dim)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh, n: int, dim: int = 0) -> torch.Tensor:
    """The ``n`` rows of every data rank's :func:`data_rows` share of ``x``
    along ``dim``, assembled in order (each share padded to the common
    size for the gather, the padding cut)."""
    per = -(-n // axis_size(mesh, "data"))
    have = x.shape[dim]
    if have < per:
        pad = list(x.shape)
        pad[dim] = per - have
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)], dim=dim)
    return all_gather(x, mesh, "data", dim).narrow(dim, 0, n)


# ------------------------------------------------------------------ launching
def spawn_ranks(argv: Sequence[str], world: int, init_method: str, timeout: float,
                env: Optional[dict] = None) -> List[str]:
    """Run ``argv + [rank, world, init_method]`` as ``world`` processes and
    return their outputs (stdout and stderr joined, through temporary
    files), in rank order. When one fails or the time runs out every other
    is killed, and the error carries the tails of all outputs."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [
            subprocess.Popen(list(argv) + [str(r), str(world), init_method], stdout=logs[r],
                             stderr=subprocess.STDOUT, text=True,
                             env=env if env is not None else dict(os.environ))
            for r in range(world)
        ]

        def outputs():
            for f in logs:
                f.flush()
                f.seek(0)
            return [f.read() for f in logs]

        deadline = time.time() + timeout
        try:
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed:
                    raise RuntimeError(f"ranks {failed} exited with "
                                       f"{[procs[r].returncode for r in failed]}")
                if time.time() > deadline:
                    raise TimeoutError(f"ranks still running after {timeout} s")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.returncode != 0]
            if failed:
                raise RuntimeError(f"ranks {failed} exited with "
                                   f"{[procs[r].returncode for r in failed]}")
        except BaseException as e:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            tails = "\n".join(f"--- rank {r}:\n{o[-4000:]}" for r, o in enumerate(outputs()))
            raise RuntimeError(f"{e}\n{tails}") from None
        finally:
            out = outputs()
            for f in logs:
                f.close()
    return out


def rank_args(argv: Optional[Sequence[str]] = None):
    """``(rank, world, init_method)`` from the last three arguments
    :func:`spawn_ranks` appends."""
    argv = sys.argv if argv is None else argv
    return int(argv[-3]), int(argv[-2]), argv[-1]
