"""Host wrappers of the hand-written CUDA kernels, each beside its plain torch twin."""
