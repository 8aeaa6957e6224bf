"""Fused MFCC: host wrapper of ``csrc/mfcc_fused.cu`` and its plain twin.

:func:`mfcc_frames` maps frames ``[B, T, L]`` (or ``[N, L]``; un-windowed,
after pre-emphasis) to cepstra ``[..., C]``. On a CUDA tensor it launches
the hand-written kernel (or raises); on a CPU tensor it runs
:func:`mfcc_frames_plain`, the same maths in plain torch.

Both take the window folded into the DFT bases (:func:`folded_bases`),
as the reference's Pallas kernel does. The kernel reads the bases as one
packed tensor-core operand (:func:`pack_basis`), made once by the caller
that owns the bases (``FeatureFrontend``). It takes any frame length and
FFT size, and up to 144 mel bands (its shared memory holds the mel rows
of a pass and the frames' mel energies). The log frame energy comes out
of the same launch as one more band and cepstrum (:func:`with_energy`).
"""

from __future__ import annotations

import torch

from ... import _build
from .tf32 import tf32_split

#: the fused kernel's bin groups per pass and depth chunk (``csrc/mfcc_fused.cu``)
GROUPS_PER_PASS, DEPTH_CHUNK = 12, 16


def folded_bases(params):
    """(diag(w) cos, diag(w) sin) from a ``FrontendParams``."""
    w = params.window[:, None]
    return (params.dft_cos * w).contiguous(), (params.dft_sin * w).contiguous()


def pack_basis(cosw: torch.Tensor, sinw: torch.Tensor) -> torch.Tensor:
    """The fused kernel's DFT operand: ``[cosw | sinw]`` split into TF32
    hi/lo planes, in the tensor cores' ``m16n8k8`` fragment order.

    Depth pads to whole chunks of 16, bins to whole passes of 12 groups
    of 8. The result is ``[G, L/16, 2, 2, 8, 4, 2, 2]``: per bin group gi, per
    depth chunk c, per 8-deep step ks, for the cos then the sin columns,
    per lane (g, t) = (lane / 4, lane % 4) the four values ``hi(W[l, 8gi+g]),
    hi(W[l+4, 8gi+g]), lo(W[l, 8gi+g]), lo(W[l+4, 8gi+g])`` with ``l = 16c +
    8ks + t``: a lane loads its fragment with one 16-byte load, and one
    group's chunk is 2 KB of contiguous memory."""
    L, bins = cosw.shape
    G, C = pack_basis_shape(L, bins)[:2]
    Lp = C * DEPTH_CHUNK
    w = torch.zeros((2, Lp, G * 8), dtype=torch.float32, device=cosw.device)
    w[0, :L, :bins] = cosw
    w[1, :L, :bins] = sinw
    planes = torch.stack(tf32_split(w))  # [2, 2, Lp, G*8]
    planes = planes.reshape(2, 2, Lp // 16, 2, 2, 4, G, 8)  # plane, cs, c, ks, h, t, gi, g
    return planes.permute(6, 2, 3, 1, 7, 5, 0, 4).contiguous()  # gi, c, ks, cs, g, t, plane, h


def with_energy(mel: torch.Tensor, dct: torch.Tensor):
    """The mel ``[K, M]`` and DCT ``[M, C]`` operands extended so that the
    kernel's column C is the log frame energy ``log(max(sum_k power,
    floor))``: an all-ones band M (the sum of the power spectrum) and a
    unit DCT row and column that pass its log through alone."""
    K, M = mel.shape
    C = dct.shape[1]
    kmel = torch.cat([mel, torch.ones((K, 1), dtype=mel.dtype, device=mel.device)], dim=1)
    kdct = torch.zeros((M + 1, C + 1), dtype=dct.dtype, device=dct.device)
    kdct[:M, :C] = dct
    kdct[M, C] = 1.0
    return kmel.contiguous(), kdct


def mfcc_frames_plain(frames, cosw, sinw, mel, dct, log_floor: float):
    """Plain torch version of the fused kernel (four matmuls)."""
    re = torch.matmul(frames, cosw)
    im = torch.matmul(frames, sinw)
    power = re * re + im * im
    log_mel = torch.log(torch.clamp(torch.matmul(power, mel), min=log_floor))
    return torch.matmul(log_mel, dct)


def mfcc_frames(frames, cosw, sinw, mel, dct, log_floor: float, basis):
    """[B, T, L] | [N, L] frames -> [..., C] cepstra (kernel on CUDA;
    ``basis`` is ``pack_basis(cosw, sinw)``)."""
    if not frames.is_cuda:
        return mfcc_frames_plain(frames, cosw, sinw, mel, dct, log_floor)
    return _launch(frames, cosw, sinw, mel, dct, log_floor, basis)


def _launch(frames, cosw, sinw, mel, dct, log_floor, basis):
    squeeze = frames.dim() == 2
    if squeeze:
        frames = frames[None]
    if frames.dim() != 3:
        raise ValueError(f"frames must be [B, T, L] or [N, L], got {tuple(frames.shape)}")
    B, T, L = frames.shape
    bins, num_mel = mel.shape
    num_ceps = dct.shape[1]
    for name, t in (("frames", frames), ("cosw", cosw), ("sinw", sinw),
                    ("mel", mel), ("dct", dct)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != frames.device:
            raise ValueError(f"{name} is on {t.device}, frames on {frames.device}")
    if frames.stride(-1) != 1 or min(frames.stride()) < 0:
        raise ValueError("frames need unit stride along the sample axis, none negative")
    for name, t in (("cosw", cosw), ("sinw", sinw), ("mel", mel), ("dct", dct)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cosw.shape != (L, bins) or sinw.shape != (L, bins) or dct.shape[0] != num_mel:
        raise ValueError(
            f"basis shapes disagree: frames L={L}, cosw {tuple(cosw.shape)}, "
            f"sinw {tuple(sinw.shape)}, mel {tuple(mel.shape)}, dct {tuple(dct.shape)}"
        )
    want = pack_basis_shape(L, bins)
    if (tuple(basis.shape) != want or basis.dtype != torch.float32
            or basis.device != frames.device or not basis.is_contiguous()):
        raise ValueError(f"basis must be pack_basis(cosw, sinw) {want} on {frames.device}")
    out = torch.empty((B * T, num_ceps), dtype=torch.float32, device=frames.device)
    if B * T:
        lib = _build.library()
        code = lib.mfcc_frames_launch(
            frames.data_ptr(), basis.data_ptr(), mel.data_ptr(),
            dct.data_ptr(), out.data_ptr(), B, T, frames.stride(0),
            frames.stride(1), L, bins, num_mel, num_ceps, float(log_floor),
            torch.cuda.current_stream(frames.device).cuda_stream,
        )
        _build.check(code, "mfcc_frames")
        mfcc_frames.launches += 1
    out = out.view(B, T, num_ceps)
    return out[0] if squeeze else out


def pack_basis_shape(L: int, bins: int):
    """Shape of :func:`pack_basis`'s result for ``[L, bins]`` bases."""
    G = -(-bins // (8 * GROUPS_PER_PASS)) * GROUPS_PER_PASS
    return (G, -(-L // DEPTH_CHUNK), 2, 2, 8, 4, 2, 2)


#: launches of the CUDA kernel since the last reset (plain runs not counted)
mfcc_frames.launches = 0
