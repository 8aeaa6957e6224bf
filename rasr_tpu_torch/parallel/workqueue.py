"""Multi-process corpus work distribution.

Counterpart of ``rasr_tpu/parallel/workqueue.py``: the reference's
scale-out is independent jobs over corpus partitions, recovered after a
failure by re-running them over idempotent artifacts. Here:

* segments partition deterministically over the ranks of
  ``torch.distributed`` (``get_rank`` / ``get_world_size`` when it is
  initialized, else 0 / 1, or explicit ids for jobs a driver starts);
* completion rides the idempotent archives (``utils/archive.py``): a
  segment whose entry exists is done, so a restarted rank resumes where
  it stopped;
* reductions across ranks (statistics, WER counters) use
  ``parallel/sharded.py``'s ``dp_accumulate`` / ``psum_counters``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import torch.distributed as dist

from ..corpus.bliss import CorpusDescription, Segment
from ..utils.archive import FileArchive
from ..utils.logging import LogManager


@dataclasses.dataclass
class WorkReport:
    processed: int
    skipped: int
    elapsed_s: float


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class CorpusWorkQueue:
    """Deterministic per-process slice of a corpus with resume support."""

    def __init__(
        self,
        corpus: CorpusDescription,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        done_archive: Optional[str] = None,
    ):
        self.corpus = corpus
        self.process_index = _process_index() if process_index is None else process_index
        self.process_count = _process_count() if process_count is None else process_count
        self.done_archive = done_archive
        self.log = LogManager.get().channel(f"workqueue.p{self.process_index}", "log")

    def segments(self) -> List[Segment]:
        """This process's partition (contiguous, like the reference's
        corpus partitions)."""
        return list(self.corpus.segments(partition=self.process_index,
                                         num_partitions=self.process_count))

    def pending(self) -> List[Segment]:
        """Partition minus segments already present in the done archive."""
        segs = self.segments()
        if not self.done_archive:
            return segs
        try:
            with FileArchive(self.done_archive, "r") as ar:
                done = set(ar.keys())
        except (FileNotFoundError, IOError):
            return segs
        return [s for s in segs if s.full_name not in done]

    def run(self, process_fn: Callable[[List[Segment]], Sequence[str]],
            batch_size: int = 8) -> WorkReport:
        """Process pending segments in batches.

        ``process_fn(batch) -> finished segment names`` must persist its
        own artifacts (into the done archive): the queue only sequences and
        reports. A crash midway loses at most one batch, which the next run
        re-does idempotently."""
        t0 = time.perf_counter()
        pend = self.pending()
        skipped = len(self.segments()) - len(pend)
        processed = 0
        for i in range(0, len(pend), batch_size):
            finished = process_fn(pend[i: i + batch_size])
            processed += len(finished)
            self.log("batch done", batch=i // batch_size, finished=len(finished),
                     total_pending=len(pend))
        return WorkReport(processed, skipped, time.perf_counter() - t0)
