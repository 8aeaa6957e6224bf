"""Kernel launches inside the decoder's span per batched frame step."""

from benchmark.metrics import per_step


def read(inputs):
    return per_step(inputs, "decoder")
