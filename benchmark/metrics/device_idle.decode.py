"""The share of the traced decode sub-window with nothing running on the device."""

from benchmark.metrics import idle


def read(inputs):
    return idle(inputs, "decode")
