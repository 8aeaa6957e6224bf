"""Streaming (online) decoding: the frame-feed search API, in PyTorch.

Counterpart of ``rasr_tpu/search/streaming.py``: per (batch of)
segment(s) ``restart()``, then ``feed()`` blocks of emission frames, with
the best sentences so far available at any time from
``current_best()``. Each feed runs the decoder's frame step over the
block from the frames fed so far (``decoder._decode_block``, the very
loop of the offline decode), so a stream that covers each utterance's
frames gives the offline results exactly. ``current_best()`` finalizes
the frontier without touching the live beam: utterances whose declared
end was not reached yet take the live beam, and the finalize reads the
carry and joins the records.

Under RNN-LM fusion each feed first compacts the hidden-state pools to
the <= 2K rows that the live beam and the frozen finals reach, then sizes
them to 2K + R x Tb rows for the block's writes (``rnn_base`` = 2K; the
reference's ``_compact_rnn_carry``), so memory per stream stays fixed
whatever its length; the finalize scores ``</s>`` from the live rows of
the utterances it takes at the frontier.

The reference pads its record buffers to 256-frame buckets to bound the
finalize's XLA compiles; eager PyTorch compiles nothing per shape, so
the port neither pads nor prewarms.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .decoder import (
    DecodeResult, DeviceDecode, TreeDecoder, _compact_rnn_carry, _decode_block, init_carry,
)

#: "length not declared": the utterance's frames stay active
_NO_END = 2**30


class StreamingDecoder:
    """Block-feed online decoder over a :class:`TreeDecoder` (any of its
    networks, lookaheads and beams)::

        sd = StreamingDecoder(decoder)
        sd.restart(batch_size=B, n_frames=totals)   # totals optional
        for block in emission_blocks:               # [B, Tb, M]
            sd.feed(block)
        results = sd.finalize()

    Feeding past a declared utterance end is safe: those rows freeze, as
    padding frames do in the offline decode."""

    def __init__(self, decoder: TreeDecoder):
        self.dec = decoder
        self._step = decoder._step()
        self._carry = None
        self._recs: list = []
        self._t = 0
        self._n_frames: Optional[torch.Tensor] = None

    def restart(self, batch_size: int, n_frames=None) -> "StreamingDecoder":
        """Begin a new batch of segments, of ``n_frames`` frames each when
        declared (ref: SearchAlgorithm::restart)."""
        dev = self.dec.device
        self._carry = init_carry(batch_size, self.dec.cfg, self.dec.lm, dev, self.dec.rnn, 0)
        self._recs = []
        self._t = 0
        self._n_frames = (
            torch.full((batch_size,), _NO_END, dtype=torch.int64, device=dev)
            if n_frames is None
            else torch.as_tensor(n_frames, device=dev).to(torch.int64)
        )
        if self._n_frames.shape != (batch_size,):
            raise ValueError(f"n_frames of shape {tuple(self._n_frames.shape)} for a batch of "
                             f"{batch_size}")
        return self

    def feed(self, emissions) -> "StreamingDecoder":
        """Advance the beam over a block of emission frames ``[B, Tb, M]``
        (host or device; device-resident blocks are used in place)."""
        if self._carry is None:
            raise RuntimeError("restart() first")
        emissions = torch.as_tensor(emissions, dtype=torch.float32, device=self.dec.device)
        if emissions.dim() != 3 or emissions.shape[0] != self._n_frames.shape[0]:
            raise ValueError(f"a block of shape {tuple(emissions.shape)} for a batch of "
                             f"{self._n_frames.shape[0]}")
        rnn_base = 0
        if self.dec.rnn is not None:
            cfg = self.dec.cfg
            rnn_base = 2 * cfg.max_hyps
            self._carry = _compact_rnn_carry(self._carry, cfg.word_end_limit * emissions.shape[1])
        self._carry, recs = _decode_block(self._step, self._carry, emissions, self._t,
                                          self._n_frames, rnn_base)
        self._recs.append(recs)
        self._t += emissions.shape[1]
        return self

    @property
    def frames_fed(self) -> int:
        return self._t

    def finalize_device(self) -> DeviceDecode:
        """The handle of the best hypotheses at the frontier (pair with
        ``decoder.results_from_device``); the stream goes on unchanged."""
        if not self._recs:
            raise RuntimeError("no frames fed")
        return self.dec._finalize(self._carry, self._recs, self._n_frames,
                                  live=self._n_frames > self._t)

    def current_best(self, names: Optional[Sequence[str]] = None) -> List[DecodeResult]:
        """Best sentences so far, without disturbing the live beam (ref:
        getCurrentBestSentence mid-segment)."""
        return self.dec.results_from_device(self.finalize_device(), names)

    def finalize(self, names: Optional[Sequence[str]] = None) -> List[DecodeResult]:
        """Final best sentences: the offline decode's when the fed frames
        cover each utterance's declared ``n_frames``."""
        return self.dec.results_from_device(self.finalize_device(), names)
