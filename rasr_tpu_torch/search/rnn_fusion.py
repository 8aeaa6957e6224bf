"""First-pass RNN-LM fusion for the tree decoder, in PyTorch.

Counterpart of ``rasr_tpu/search/rnn_fusion.py`` (ref: src/Lm/TF* —
Lm::TFRecurrentLanguageModel: an RNN LM scored during the search with
per-history hidden-state caching; recombination stays on truncated
histories). The hidden states live in a pool ``[B, P + 1, H]`` beside the
beam, and each hypothesis carries its state's pool row as one more
payload column:

* per frame, the R word-end records of each utterance take one LSTM step
  and one full-vocabulary projection from their sources' rows; the new
  states fill the frame's R rows of the pool and the re-entry hypotheses
  point at them;
* recombination stays exact equality of (tree state, n-gram state): of
  two hypotheses with equal keys and different RNN histories the better
  one's row survives, the reference's semantics of on-the-fly rescoring
  with truncated-history recombination. Under an n-gram LM whose order
  covers the utterance the truncation is vacuous and the fused scores
  are exact path scores (the parity tests use this);
* the offline decode sizes the pool to R x T rows; a stream compacts it
  between feeds to the <= 2K rows that the live beam and the frozen
  finals reach and sizes it to 2K + R x Tb per block, so memory per
  stream stays fixed whatever its length (``search/streaming.py``).

The fused cost of a word end is ``lm_scale * ngram + weight * rnn``;
silence leaves the RNN state as it is and costs nothing on the RNN side,
and a word the RNN LM does not know pays ``weight * oov_cost`` and leaves
the state as it is too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..device import resolve
from ..models.nn import strict_precision


@dataclasses.dataclass(frozen=True)
class RnnFusionTables:
    """The fused RNN LM as tensors (a plain LSTM cell and projection).

    ``gates = x @ wx + h @ wh + b`` in gate order i, f, g, o (flax's cell:
    sigmoid i / f / o, tanh g, hidden bias only). ``word_map`` maps the
    n-gram LM's word ids to RNN vocabulary ids (-1: unknown to the RNN)."""

    emb: torch.Tensor  # [Vr, E]
    wx: torch.Tensor  # [E, 4H]
    wh: torch.Tensor  # [H, 4H]
    b: torch.Tensor  # [4H]
    proj_w: torch.Tensor  # [H, Vr]
    proj_b: torch.Tensor  # [Vr]
    word_map: torch.Tensor  # [V_ngram] i64
    init_c: torch.Tensor  # [H] state after <s>
    init_h: torch.Tensor  # [H]
    weight: float
    oov_cost: float
    end_wid: int  # RNN vocabulary id of </s> (-1: no sentence-end score)

    @property
    def hidden(self) -> int:
        return self.wh.shape[0]

    def to(self, device) -> "RnnFusionTables":
        arrays = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                  if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **arrays)


def cell_step(rnn: RnnFusionTables, x, c, h):
    """Batched LSTM cell step: x ``[..., E]``, c / h ``[..., H]`` -> (c', h')."""
    H = rnn.hidden
    with strict_precision():
        gates = x @ rnn.wx + h @ rnn.wh + rnn.b
    i = torch.sigmoid(gates[..., :H])
    f = torch.sigmoid(gates[..., H: 2 * H])
    g = torch.tanh(gates[..., 2 * H: 3 * H])
    o = torch.sigmoid(gates[..., 3 * H:])
    c2 = f * c + i * g
    return c2, o * torch.tanh(c2)


def word_scores(rnn: RnnFusionTables, h, wid):
    """``-log p(wid | state h)``: h ``[..., H]``, wid ``[...]`` (>= 0); the
    log-sum-exp of the logits less the picked logit."""
    with strict_precision():
        logits = h @ rnn.proj_w + rnn.proj_b  # [..., Vr]
    picked = logits.gather(-1, wid.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - picked


def build_rnn_fusion(
    rnn_lm,  # models.lm.rnn.RnnLm
    ngram_vocab: Dict[str, int],
    weight: float = 0.5,
    oov_cost: float = 99.0,
    device=None,
) -> RnnFusionTables:
    """The decoder's fusion tables of an :class:`~..models.lm.rnn.RnnLm`
    over the decoder LM's token -> id map (the decoder's word ids are
    n-gram LM ids; tokens the RNN LM lacks map to -1), with the state
    after ``<s>`` as every hypothesis' start. On ``device`` (the card when
    None)."""
    device = resolve(device)
    m = rnn_lm.model
    V = max(ngram_vocab.values()) + 1 if ngram_vocab else 1
    word_map = np.full(V, -1, np.int64)
    for tok, i in ngram_vocab.items():
        r = rnn_lm.vocab.get(tok)
        if r is not None:
            word_map[i] = r

    def dev(x):
        return x.detach().to(device=device, dtype=torch.float32).clone()

    H = m.hidden_dim
    tables = RnnFusionTables(
        emb=dev(m.embed.weight), wx=dev(m.wx), wh=dev(m.wh), b=dev(m.b),
        proj_w=dev(m.proj.weight.T), proj_b=dev(m.proj.bias),
        word_map=torch.as_tensor(word_map, device=device),
        init_c=torch.zeros(H, device=device), init_h=torch.zeros(H, device=device),
        weight=float(weight), oov_cost=float(oov_cost),
        end_wid=int(rnn_lm.vocab.get("</s>", -1)),
    )
    bos = rnn_lm.vocab.get("<s>", 0)
    zero = torch.zeros((1, H), device=device)
    c0, h0 = cell_step(tables, tables.emb[bos][None], zero, zero)
    return dataclasses.replace(tables, init_c=c0[0], init_h=h0[0])
