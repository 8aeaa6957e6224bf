"""Fused word-end block: host wrapper of ``csrc/wordend_fused.cu`` and its plain twin.

:func:`wordend_block` is the port of the TPU kernel of
``examples/pallas_wordend_microbench.py`` (``make_kernel``, semantics
``xla_block``): the deferred-emission word-end stage of the decoder frame
for the ``[B, KW]`` survivors (``KW = K + R3``). Per slot it reads one row
of the packed ``combo [S1, Cc]`` int32 table (column 0 word, 1 the
word-end cost adjustment as float32 bits, 2 lemma, 3 next state, 4
emission class, ``8 : 8 + C_sp`` the state-pack row), adds the frame's
emission ``emis[b, class]`` to the survivor's score and the adjustment to
that:

    w2  = w_score < BIG/2 ? w_score + emis[b, cls] : BIG
    pre = word != WORD_NONE ? w2 + adj : BIG

and returns ``(pre, w2, word, lemma, next, spk)``. On a CUDA tensor it
launches the kernel (or raises); on a CPU tensor it runs
:func:`wordend_block_plain`, the torch transcription of ``xla_block``.
``BIG`` and ``WORD_NONE`` are the example's constants. Indices (states
below ``S1``, classes below ``C``) are assumed in range, as in the Pallas
kernel. The decoder does not call it yet.
"""

from __future__ import annotations

import torch

from ... import _build

__all__ = ["BIG", "WORD_NONE", "wordend_block", "wordend_block_plain"]

BIG = 1e30
WORD_NONE = -(2**31) + 1


def wordend_block_plain(w_state, w_score, combo, emis, c_sp: int):
    """Plain torch version of the fused kernel (``xla_block``)."""
    pk = combo[w_state.long()]  # [B, KW, Cc]
    word = pk[..., 0]
    adj = pk[..., 1].contiguous().view(torch.float32)
    e = emis.gather(1, pk[..., 4].long())
    w2 = torch.where(w_score < BIG / 2, w_score + e, BIG)
    pre = torch.where(word != WORD_NONE, w2 + adj, BIG)
    return pre, w2, word, pk[..., 2], pk[..., 3], pk[..., 8 : 8 + c_sp]


def _check(w_state, w_score, combo, emis, c_sp: int) -> None:
    for name, t, dtype, ndim in (("w_state", w_state, torch.int32, 2),
                                 ("w_score", w_score, torch.float32, 2),
                                 ("combo", combo, torch.int32, 2),
                                 ("emis", emis, torch.float32, 2)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")
        if t.device != w_state.device:
            raise ValueError(f"{name} is on {t.device}, w_state on {w_state.device}")
    if w_score.shape != w_state.shape:
        raise ValueError(f"w_score {tuple(w_score.shape)} != w_state {tuple(w_state.shape)}")
    if emis.shape[0] != w_state.shape[0]:
        raise ValueError(f"emis has {emis.shape[0]} rows for a batch of {w_state.shape[0]}")
    if c_sp < 0 or combo.shape[1] < max(8 + c_sp, 5):
        raise ValueError(f"combo rows of {combo.shape[1]} columns hold no {c_sp}-wide state pack")


def wordend_block(w_state, w_score, combo, emis, c_sp: int):
    """[B, KW] survivors -> (pre, w2, word, lemma, next [B, KW], spk [B, KW, C_sp])."""
    _check(w_state, w_score, combo, emis, c_sp)
    if not w_state.is_cuda:
        return wordend_block_plain(w_state, w_score, combo, emis, c_sp)
    B, KW = w_state.shape
    dev = w_state.device
    pre = torch.empty((B, KW), dtype=torch.float32, device=dev)
    w2 = torch.empty_like(pre)
    word, lemma, nxt = (torch.empty((B, KW), dtype=torch.int32, device=dev) for _ in range(3))
    spk = torch.empty((B, KW, c_sp), dtype=torch.int32, device=dev)
    if B * KW:
        code = _build.library().wordend_block_launch(
            w_state.data_ptr(), w_score.data_ptr(), combo.data_ptr(), emis.data_ptr(),
            pre.data_ptr(), w2.data_ptr(), word.data_ptr(), lemma.data_ptr(), nxt.data_ptr(),
            spk.data_ptr(), B * KW, KW, combo.shape[1], emis.shape[1], c_sp,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(code, "wordend_block")
        wordend_block.launches += 1
    return pre, w2, word, lemma, nxt, spk


#: launches of the CUDA kernel since the last reset (plain runs not counted)
wordend_block.launches = 0
