"""rasr_tpu_torch.tools: the command-line tools, ``python -m rasr_tpu_torch.tools.<tool>``."""
