"""Cross-entropy training steps of a network, in plain PyTorch.

The loss of a step is the mean per-frame cross entropy of the model's
logits (the model's plain reference, given as a function, such as
``reference/conformer.py::logits``: float32, TF32 off) against the frame
labels; the gradient comes from autograd, one utterance at a time, and
the update is SGD with heavy-ball momentum (buffer = momentum * buffer +
gradient, parameter -= learning rate * buffer; the buffer starts at the
first gradient).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from .precision import QUANT


class _Rounded(torch.autograd.Function):
    """Rounds the operand going forward and the gradient coming back."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def rounded(name: Optional[str]) -> Optional[Callable]:
    """The product-operand rounding of a lower-precision control, or None."""
    if name is None:
        return None
    fn = QUANT[name]
    return lambda x: _Rounded.apply(x, fn)


def steps(logits: Callable, weights: Dict[str, torch.Tensor], batches: List, cfg: dict,
          quant: Optional[str] = None):
    """Run ``len(batches)`` steps from ``weights``, with ``logits(x,
    params, cfg, quant)`` the network's logits of one utterance: returns
    the losses, the first step's gradients and the parameters' change over
    all steps."""
    tc = cfg["train"]
    if tc["optimizer"] != "momentum" or tc["l2"] != 0.0:
        raise NotImplementedError("the reference trains with plain momentum SGD")
    q = rounded(quant)
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    buf, losses, first = {}, [], None
    for x, y, w in batches:
        for p in params.values():
            p.grad = None
        total = float(w.sum())
        loss = 0.0
        for i in range(x.shape[0]):
            ce = F.cross_entropy(logits(x[i].float(), params, cfg, q).double(), y[i].long(),
                                 reduction="none")
            part = (ce * w[i].double()).sum() / total
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            for k, p in params.items():
                if p.grad is None:  # a leaf the logits do not read has no gradient
                    p.grad = torch.zeros_like(p)
                g = p.grad
                buf[k] = g.clone() if k not in buf else buf[k].mul_(tc["momentum"]).add_(g)
                p.sub_(tc["learning_rate"] * buf[k])
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in params.items()}
    change = {k: (params[k].detach() - start[k]) for k in params}
    return losses, first, change
