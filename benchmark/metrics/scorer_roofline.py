"""The scorer span's work (`counts/`) at the card's peaks over the device time it launched."""

from benchmark.metrics import roofline


def read(inputs):
    return roofline(inputs, "scorer")
