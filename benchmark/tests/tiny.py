"""Runs of the harness on the CPU at a size a test can hold."""

from __future__ import annotations

import time

import torch

from benchmark import spec


def tiny_run(workload: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False,
             control=None, limits=None) -> spec.Run:
    """The cell ``workload`` cut to a few hundred words and classes, a
    small beam, the model's own cut (``benchmark/models/<scorer>.py::tiny``:
    a two-block conformer of width 32) and batches of four, on the CPU.
    ``limits`` replaces the configuration's limits."""
    r = spec.resolve(spec.benchmark(), workload, seed=seed, seconds=seconds, trace=trace,
                     device=torch.device("cpu"), started=time.time(), control=control)
    c = r.cfg
    c["lexicon"]["num_words"] = 300
    c["tying"]["num_classes"] = 300
    c["beam"].update(max_hyps=64, root_select=64, branch_hyps=16, root_hyps=4)
    spec.model(c).tiny(c)
    if r.traffic["job"] == "decode":
        r.traffic.update(batch=4, min_s=1.0, max_s=2.0, warmup_s=1.0, check_utterances=3)
    elif r.traffic["job"] == "align":
        r.traffic.update(batch=4, min_s=3.0, max_s=3.0, words=[2, 6], warmup_s=1.0,
                         check_utterances=3)
    else:
        r.traffic.update(batch=4, frames=40)
    if limits is not None:
        c["limits"] = limits
    return r
