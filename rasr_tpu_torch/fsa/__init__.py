"""rasr_tpu_torch.fsa."""
