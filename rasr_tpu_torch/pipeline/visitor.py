"""Corpus visiting with utterance batching.

Re-implements the reference's corpus processing drivers
(ref: src/Speech/CorpusVisitor.*, CorpusProcessor.*, DataExtractor.*):
there, processors visit one segment at a time; TPU-natively the visitor
yields *batches* of segments bucketed by duration (static shapes per
bucket minimize recompilation and padding waste) with partition /
segment-list selection preserved.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..corpus.audio import extract_segment, read_audio
from ..corpus.bliss import CorpusDescription, Segment


@dataclasses.dataclass
class SegmentBatch:
    segments: List[Segment]
    samples: np.ndarray  # [B, S_max] float32
    lengths: np.ndarray  # [B] int64

    @property
    def names(self) -> List[str]:
        return [s.full_name for s in self.segments]

    @property
    def orths(self) -> List[str]:
        return [s.orth for s in self.segments]


class CorpusVisitor:
    """Iterates duration-bucketed segment batches."""

    def __init__(
        self,
        corpus: CorpusDescription,
        batch_size: int = 8,
        partition: int = 0,
        num_partitions: int = 1,
        segment_list: Optional[List[str]] = None,
        bucket_tolerance: float = 2.0,
        sample_rate: int = 16000,
        load_audio: bool = True,
    ):
        self.corpus = corpus
        self.batch_size = batch_size
        self.partition = partition
        self.num_partitions = num_partitions
        self.segment_list = segment_list
        self.bucket_tolerance = bucket_tolerance
        self.sample_rate = sample_rate
        #: False = metadata-only batches (empty samples, lengths from the
        #: segment times) for consumers reading cached features instead
        self.load_audio = load_audio
        self._audio_cache: Tuple[Optional[str], Optional[object]] = (None, None)

    def _read(self, seg: Segment) -> np.ndarray:
        path, audio = self._audio_cache
        if path != seg.recording.audio:
            audio = read_audio(seg.recording.audio, self.sample_rate)
            self._audio_cache = (seg.recording.audio, audio)
        return extract_segment(audio, seg.start, seg.end, seg.track)

    def batches(self) -> Iterator[SegmentBatch]:
        segs = list(
            self.corpus.segments(self.partition, self.num_partitions, self.segment_list)
        )
        # bucket by duration: sort, then chunk — keeps padding waste low
        segs.sort(key=lambda s: s.duration)
        for i in range(0, len(segs), self.batch_size):
            chunk = segs[i : i + self.batch_size]
            if not self.load_audio:
                lengths = np.array(
                    [int(round(s.duration * self.sample_rate)) for s in chunk],
                    np.int64,
                )
                yield SegmentBatch(chunk, np.zeros((len(chunk), 0), np.float32), lengths)
                continue
            waves = [self._read(s) for s in chunk]
            S = max((len(w) for w in waves), default=0)
            samples = np.zeros((len(chunk), S), np.float32)
            lengths = np.zeros(len(chunk), np.int64)
            for j, w in enumerate(waves):
                samples[j, : len(w)] = w
                lengths[j] = len(w)
            yield SegmentBatch(chunk, samples, lengths)


def prefetch_batches(visitor: "CorpusVisitor", depth: int = 2):
    """Background-thread batch prefetch: audio read + pad of batch i+1
    overlaps the device work on batch i (the reference overlaps nothing —
    its Flow pull is synchronous per frame; here host IO is the only
    non-device stage left, so one thread suffices).

    Yields the same batches as ``visitor.batches()``; worker exceptions
    re-raise in the consumer. If the consumer abandons the generator
    (e.g. decode raises mid-corpus), the worker notices via the stop
    event and exits instead of blocking on a full queue forever."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in visitor.batches():
                if not put(batch):
                    return
            put(_END)
        except BaseException as exc:  # propagate into the consumer
            put(exc)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()
