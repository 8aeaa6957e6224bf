"""Training-state checkpointing.

Counterpart of ``rasr_tpu/train/checkpoint.py``: step-indexed checkpoints
of the full training state (the model's and the optimizer's
``state_dict``, and what the caller adds) plus JSON metadata (epoch and
minibatch cursor), so NN epochs resume mid-schedule. The reference writes
flax msgpack, which cannot be read without flax; the port writes
``ckpt_<step>.pt`` with ``torch.save`` beside the same ``ckpt_<step>.json``
and loads with ``weights_only=True`` (tensors and plain containers
only). The manager keeps the newest ``max_to_keep`` steps.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch


class CheckpointManager:
    """Step-indexed checkpoints of a ``torch.save``-able state + metadata."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    def save(self, step: int, state: Any, metadata: Optional[Dict] = None) -> str:
        path = self._path(step)
        torch.save(state, path + ".pt")
        with open(path + ".json", "w", encoding="utf-8") as fh:
            json.dump({"step": step, **(metadata or {})}, fh)
        self._gc()
        return path

    def restore(self, step: Optional[int] = None, map_location=None) -> Tuple[Any, Dict]:
        """(state, metadata) of ``step`` (the latest when None)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        state = torch.load(path + ".pt", map_location=map_location, weights_only=True)
        with open(path + ".json", "r", encoding="utf-8") as fh:
            meta = json.load(fh)
        return state, meta

    def all_steps(self) -> List[int]:
        return sorted(int(name[5:13]) for name in os.listdir(self.directory)
                      if name.startswith("ckpt_") and name.endswith(".json"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.max_to_keep)]:
            for suffix in (".pt", ".json"):
                try:
                    os.remove(self._path(s) + suffix)
                except FileNotFoundError:
                    pass
