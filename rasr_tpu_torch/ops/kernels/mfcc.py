"""Fused MFCC: host wrapper of ``csrc/mfcc_fused.cu`` and its plain twin.

:func:`mfcc_frames` maps frames ``[B, T, L]`` (or ``[N, L]``; un-windowed,
after pre-emphasis) to cepstra ``[..., C]``. On a CUDA tensor it launches
the hand-written kernel (or raises); on a CPU tensor it runs
:func:`mfcc_frames_plain`, the same maths in plain torch.

Both take the window folded into the DFT bases (:func:`folded_bases`),
as the reference's Pallas kernel does.
"""

from __future__ import annotations

import torch

from ... import _build


def folded_bases(params):
    """(diag(w) cos, diag(w) sin) from a ``FrontendParams``."""
    w = params.window[:, None]
    return (params.dft_cos * w).contiguous(), (params.dft_sin * w).contiguous()


def mfcc_frames_plain(frames, cosw, sinw, mel, dct, log_floor: float):
    """Plain torch version of the fused kernel (four matmuls)."""
    re = torch.matmul(frames, cosw)
    im = torch.matmul(frames, sinw)
    power = re * re + im * im
    log_mel = torch.log(torch.clamp(torch.matmul(power, mel), min=log_floor))
    return torch.matmul(log_mel, dct)


def mfcc_frames(frames, cosw, sinw, mel, dct, log_floor: float):
    """[B, T, L] | [N, L] frames -> [..., C] cepstra (kernel on CUDA)."""
    if not frames.is_cuda:
        return mfcc_frames_plain(frames, cosw, sinw, mel, dct, log_floor)
    return _launch(frames, cosw, sinw, mel, dct, log_floor)


def _launch(frames, cosw, sinw, mel, dct, log_floor):
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
    if frames.stride(-1) != 1:
        raise ValueError("frames need unit stride along the sample axis")
    for name, t in (("cosw", cosw), ("sinw", sinw), ("mel", mel), ("dct", dct)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cosw.shape != (L, bins) or sinw.shape != (L, bins) or dct.shape[0] != num_mel:
        raise ValueError(
            f"basis shapes disagree: frames L={L}, cosw {tuple(cosw.shape)}, "
            f"sinw {tuple(sinw.shape)}, mel {tuple(mel.shape)}, dct {tuple(dct.shape)}"
        )
    out = torch.empty((B * T, num_ceps), dtype=torch.float32, device=frames.device)
    if B * T:
        lib = _build.library()
        code = lib.mfcc_frames_launch(
            frames.data_ptr(), cosw.data_ptr(), sinw.data_ptr(), mel.data_ptr(),
            dct.data_ptr(), out.data_ptr(), B, T, frames.stride(0),
            frames.stride(1), L, bins, num_mel, num_ceps, float(log_floor),
            torch.cuda.current_stream(frames.device).cuda_stream,
        )
        _build.check(code, "mfcc_frames")
        mfcc_frames.launches += 1
    out = out.view(B, T, num_ceps)
    return out[0] if squeeze else out


#: launches of the CUDA kernel since the last reset (plain runs not counted)
mfcc_frames.launches = 0
