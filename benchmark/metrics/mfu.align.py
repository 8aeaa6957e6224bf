"""The align window's model operations at the card's peaks over the window."""

from benchmark.metrics import mfu


def read(inputs):
    return mfu(inputs, "align")
