"""Cross-entropy training of the configuration's network from resident
feature chunks.

Set-up builds one ``SequenceTrainer`` over the port's network of the
configuration's model (``benchmark/models/<scorer>.py::net``) from the
drawn weights and drives it through its first steps with the window's own
call (``_update``) on distinct batches of the pool; the window then goes
on with the same object over the pool, round robin. Every step trains
``batch`` x ``frames`` frames; the rate is all frames trained in the
window over its length, which ends in a synchronize.

The plain reference follows the first steps: each step's loss, the first
gradient per parameter (the momentum buffer after step one), and each
parameter's change over the first steps (read before the next step).
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from .. import spec, trace, traffic
from ..reference import train as rtrain

SPANS = ("train_step",)


def model(cfg: dict):
    """The configuration's model module, which has to have a network."""
    am = spec.model(cfg)
    if not hasattr(am, "net"):
        raise ValueError(f"the train job trains a network, and the acoustic model "
                         f"{cfg['scorer']!r} has none (benchmark/models/{cfg['scorer']}.py "
                         f"has no net())")
    return am


def build(cfg: dict, weights, device):
    """The port's trainer over the drawn weights."""
    from rasr_tpu_torch.train.nn_trainer import SequenceTrainer, TrainConfig

    net = model(cfg).net(cfg, weights, device)
    tc = cfg["train"]
    return SequenceTrainer(net, cfg["tying"]["num_classes"],
                           TrainConfig(optimizer=tc["optimizer"],
                                       learning_rate=tc["learning_rate"],
                                       momentum=tc["momentum"], l2=tc["l2"]))


def run(r) -> dict:
    cfg, t, dev = r.cfg, r.traffic, r.device
    D, M = cfg["frontend"]["feat_dim"], cfg["tying"]["num_classes"]
    am = model(cfg)
    weights = am.weights(cfg, r.seed, dev)
    trainer = build(cfg, weights, dev)
    pool = traffic.chunk_pool(t, D, M, r.seed, dev)
    first = t["first_steps"]

    def step(k):
        with trace.span("train_step"):
            return trainer._update(*pool[k % len(pool)])

    names = [n for n, _ in trainer.model.named_parameters()]
    losses = []
    for k in range(first):
        losses.append(float(step(k)[0]))
        if k == 0:  # the first gradient, as the optimizer holds it
            grad1 = {n: trainer.opt.state[p].get("momentum_buffer", torch.zeros_like(p)).clone()
                     for n, p in trainer.model.named_parameters()}
    after = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    step(first)  # one more: the window's own shapes and state, warm
    trace.sync()
    setup_s = time.time() - r.started

    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    trace.sync()
    t0 = time.perf_counter()
    k = first + 1
    while time.perf_counter() - t0 < r.seconds:
        step(k)
        k += 1
    trace.sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    n_steps = k - first - 1
    frames = n_steps * t["batch"] * t["frames"]
    print(f"[train] {n_steps} steps, {frames} frames in {window_s:.2f} s: "
          f"{frames / window_s:.1f} frames/s; set-up {setup_s:.2f} s", file=sys.stderr)
    work = am.train_step_work(t["batch"], t["frames"], cfg)
    step_work = work
    for _ in range(n_steps - 1):
        work = work + step_work
    layer = {"window": {"train": (work, window_s)}}
    if r.trace:
        with trace.profiled() as prof:
            for j in range(3):
                step(k + j)
        layer["summary"] = trace.summarize(prof, SPANS)
        layer["steps"] = {"train_step": 3}
    out = {"end_to_end": {"train_frames_per_s": frames / window_s, "setup_s": setup_s},
           "attempted": n_steps, "memory_peak_bytes": peak, "layer": layer}

    del trainer, pool
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out.update(check(r, weights, losses, grad1, after, names))
    return out


def leaf_gap(got: dict, want: dict, keep) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    norms = {k: float(want[k].double().norm()) for k in keep}
    med = statistics.median(norms.values())
    return max(abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], med) for k in keep)


def check(r, weights, losses, grad1, after, names) -> dict:
    """The port's first steps against the reference's."""
    cfg, t, dev = r.cfg, r.traffic, r.device
    D, M = cfg["frontend"]["feat_dim"], cfg["tying"]["num_classes"]
    pool = traffic.chunk_pool(t, D, M, r.seed, dev)[: len(losses)]
    logits = model(cfg).reference_logits
    ref_losses, ref_grad, ref_change = rtrain.steps(logits, weights, pool, cfg)
    if r.control:  # the reference in a lower precision, in the program's place
        losses, grad1, change = rtrain.steps(logits, weights, pool, cfg, r.control)
    else:
        change = {n: after[n] - weights[n] for n in names}
    # leaves whose reference gradient is nought to rounding move by round-off alone
    gnorm = {n: float(ref_grad[n].double().norm()) for n in names}
    med = statistics.median(gnorm.values())
    moving = [n for n in names if gnorm[n] >= 1e-3 * med]
    limits = cfg["limits"]["train"]
    got = {"loss_gap": max(abs(a - b) for a, b in zip(losses, ref_losses)),
           "grad_norm_gap": leaf_gap(grad1, ref_grad, moving),
           "update_norm_gap": leaf_gap(change, ref_change, moving)}
    print(f"[train] losses {losses} reference {ref_losses}; {len(names) - len(moving)} of "
          f"{len(names)} leaves left out (gradient under 1e-3 of the median leaf's)",
          file=sys.stderr)
    failed = int(any(limits[k] is None or got[k] > limits[k] for k in got))
    return {"failed": failed, "check": {k: (got[k], limits[k]) for k in got}}
