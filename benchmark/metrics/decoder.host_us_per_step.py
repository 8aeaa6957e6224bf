"""Host microseconds per batched frame step of the decoder's dispatch: the
median over the decodes of the program's ``decode.dispatch`` span over its
``steps`` count (outside the profiled batch)."""

from benchmark.metrics._program import median_us


def read(inputs):
    return median_us("decode.dispatch", "steps")
