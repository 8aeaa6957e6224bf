"""rasr_tpu_torch.ops."""
