"""Kernel launches inside the aligner's span per frame step of its Viterbi pass."""

from benchmark.metrics import per_step


def read(inputs):
    return per_step(inputs, "aligner")
