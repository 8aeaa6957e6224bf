"""Host microseconds to build one utterance's linear alignment graph: the
median of the program's ``align.graph`` spans (outside the profiled
batch)."""

from benchmark.metrics._program import median_us


def read(inputs):
    return median_us("align.graph")
