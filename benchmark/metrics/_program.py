"""The program's own spans, as the readers of host time read them.

``rasr_tpu_torch.utils.profiling`` keeps the spans the port records
inside its layers. A reader takes those made while no ``torch.profiler``
recorded: the warm-up and the measured window, not the profiled batch.
A program without the recorder, or without the span, gives none.
"""

import statistics
from collections import defaultdict


def unprofiled(name: str) -> list:
    """The program's kept spans ``name`` made outside the profiled batch."""
    from rasr_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    if records is None:
        return []
    return [sp for sp in records(name) if not sp.profiled]


def median_us(name: str, per: str = "", less: str = ""):
    """The median over the spans ``name`` of their microseconds, less those
    of their child spans ``less`` where one is named, each over its count
    ``per`` where one is named; None where there are none."""
    inner = defaultdict(int)
    for sp in unprofiled(less) if less else ():
        inner[sp.parent] += sp.end_ns - sp.start_ns
    got = [(sp.end_ns - sp.start_ns - inner[sp.id]) / 1e3 / (sp.counts[per] if per else 1)
           for sp in unprofiled(name) if not per or sp.counts.get(per)]
    return statistics.median(got) if got else None
