"""Runnable examples of the port (``python -m rasr_tpu_torch.examples.<name>``)."""
