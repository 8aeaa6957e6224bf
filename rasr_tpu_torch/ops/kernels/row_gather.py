"""Row gather: host wrapper of ``csrc/row_gather.cu`` and its plain twin.

:func:`row_gather` is the port of the TPU kernel of
``examples/pallas_gather_microbench.py`` (``make_pallas_gather``):
``out[n, :] = table[idx[n], :]`` for an int32 table ``[S, C]`` and int32
indices ``[N]``. On a CUDA tensor it launches the kernel (or raises); on
a CPU tensor it runs :func:`row_gather_plain`, ``table[idx]``. Indices
are assumed in ``[0, S)``, as in the Pallas kernel: the kernel does not
check them.
"""

from __future__ import annotations

import torch

from ... import _build

__all__ = ["row_gather", "row_gather_plain"]


def row_gather_plain(table, idx):
    """Plain torch version of the kernel."""
    return table[idx.long()]


def row_gather(table, idx):
    """[S, C] int32 table, [N] int32 indices -> [N, C] int32 rows."""
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"table and idx must be int32, got {table.dtype} and {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be [S, C] and idx [N], got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.device != idx.device:
        raise ValueError(f"table is on {table.device}, idx on {idx.device}")
    if not table.is_cuda:
        return row_gather_plain(table, idx)
    N, C = idx.shape[0], table.shape[1]
    out = torch.empty((N, C), dtype=torch.int32, device=table.device)
    if N * C:
        vec4 = C % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        code = _build.library().row_gather_launch(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, C, int(vec4),
            torch.cuda.current_stream(table.device).cuda_stream,
        )
        _build.check(code, "row_gather")
        row_gather.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (plain runs not counted)
row_gather.launches = 0
