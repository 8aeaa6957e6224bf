"""rasr_tpu_torch.search."""
