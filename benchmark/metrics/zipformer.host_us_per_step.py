"""Host microseconds of the Zipformer's forward per training step: the
median over the steps of the program's ``zipformer.forward`` span (one a
step, outside the profiled steps). Read it against ``device_idle.train``:
where the host outruns the card, the forward's launches block and the
span reads the card's time."""

from benchmark.metrics._program import median_us


def read(inputs):
    return median_us("zipformer.forward")
