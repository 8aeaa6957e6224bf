"""rasr_tpu_torch.corpus."""
