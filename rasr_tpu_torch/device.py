"""Device selection for the port's main path."""

from __future__ import annotations

import torch


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device the main path runs on. Raises when no card is
    visible: nothing that expects a card carries on on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible (torch.cuda.is_available() is False)")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} visible"
        )
    return torch.device("cuda", index)
