"""Kernel launches inside the training step's span per step: the launch
load of the multi-rate Zipformer's forward, backward and update."""

from benchmark.metrics import per_step


def read(inputs):
    return per_step(inputs, "train_step")
