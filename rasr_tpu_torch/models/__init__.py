"""rasr_tpu_torch.models."""
