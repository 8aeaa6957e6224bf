"""Host microseconds per frame of the batched Viterbi alignment: the median
over the batches of the program's ``align.viterbi`` span, less its
``align.read`` children (the reads that wait for the card), over its
``frames`` count (outside the profiled batch)."""

from benchmark.metrics._program import median_us


def read(inputs):
    return median_us("align.viterbi", "frames", less="align.read")
