"""rasr_tpu_torch.align: alignment graphs and batched forced alignment."""
