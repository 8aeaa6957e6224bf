"""The share of the traced align sub-window with nothing running on the device."""

from benchmark.metrics import idle


def read(inputs):
    return idle(inputs, "align")
