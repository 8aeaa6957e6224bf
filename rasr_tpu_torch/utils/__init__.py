"""rasr_tpu_torch.utils."""
