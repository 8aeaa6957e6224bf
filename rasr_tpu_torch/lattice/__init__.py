"""rasr_tpu_torch.lattice."""
