"""Device selection for the port's main path, and device timing."""

from __future__ import annotations

import subprocess

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


def resolve(device=None) -> torch.device:
    """``device``, or the card (:func:`cuda_device`) when it is None: the
    port's entry points run on the card unless the caller names another
    device, as the CPU tests do with ``device="cpu"``."""
    return cuda_device() if device is None else torch.device(device)


def resolve_for(x, device=None) -> torch.device:
    """The device to compute on for input ``x``: ``device`` when given,
    else ``x``'s own when it is a tensor, else the card (:func:`resolve`)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve(device)


def card_tag() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (a
    card set below its full power runs slower under load: every number
    measured on it carries this tag)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` calls, after one
    warm-up call (CUDA events around the run of calls)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms with the host's dispatch taken
    out: ``reps`` calls captured into one CUDA graph, replayed once to
    warm up and once between CUDA events. ``fn`` must launch on the
    current stream and must not synchronise."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
