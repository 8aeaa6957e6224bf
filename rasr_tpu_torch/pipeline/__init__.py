"""rasr_tpu_torch.pipeline."""
