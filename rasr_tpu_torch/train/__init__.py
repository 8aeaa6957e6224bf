"""rasr_tpu_torch.train: EM, LDA, speaker adaptation and NN training."""
