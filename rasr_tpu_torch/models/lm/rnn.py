"""Recurrent neural language model with hidden-state caching, in PyTorch.

Counterpart of ``rasr_tpu/models/lm/rnn.py`` (ref: src/Lm/TF* —
Lm::TFRecurrentLanguageModel: an RNN LM with interned histories,
per-history hidden-state caching and batched score requests). The model
is :class:`LstmLm`, flax's ``LstmLmModule`` as a torch module: an
embedding, one LSTM cell in ``OptimizedLSTMCell``'s layout (input kernels
``ii / if / ig / io`` without bias, hidden kernels ``hi / hf / hg / ho``
with bias, gate order i, f, g, o; carried as the concatenated ``wx``,
``wh`` and ``b``) and the ``proj`` output layer. Histories are word-id
tuples memoizing ``(log-probabilities, carry)``; the cache evicts the
first-inserted entry when full, as the reference's does.

Uses: n-best / lattice rescoring (``lattice/flf.py::rescore_lm`` takes
any LanguageModel) and first-pass fusion (``search/rnn_fusion.py``).

Artifacts are the port's own: ``<path>.json`` holds the reference's
header (``vocab``, ``embed_dim``, ``hidden_dim``) and ``<path>.pt`` the
parameters, written by ``torch.save`` and read with ``weights_only=True``
(the reference's msgpack image needs flax to read).
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve
from ..nn import _lecun, _orthogonal, strict_precision
from .interface import History, LanguageModel

#: the cost of a word the RNN LM does not know (no ``<unk>`` embedding)
OOV_COST = 99.0


class LstmLm(nn.Module):
    """tokens ``[B, T]`` -> (logits ``[B, T, V]``, final carry ``(c, h)``)."""

    def __init__(self, vocab_size: int, embed_dim: int = 64, hidden_dim: int = 128):
        super().__init__()
        self.vocab_size, self.embed_dim, self.hidden_dim = vocab_size, embed_dim, hidden_dim
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.wx = nn.Parameter(torch.zeros(embed_dim, 4 * hidden_dim))  # ii|if|ig|io
        self.wh = nn.Parameter(torch.zeros(hidden_dim, 4 * hidden_dim))  # hi|hf|hg|ho
        self.b = nn.Parameter(torch.zeros(4 * hidden_dim))  # the hidden kernels' bias
        self.proj = nn.Linear(hidden_dim, vocab_size)

    def zero_carry(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """flax's ``initialize_carry``: zeros."""
        z = torch.zeros((batch, self.hidden_dim), device=self.b.device)
        return z, z

    def forward(self, tokens: torch.Tensor, carry=None):
        emb = self.embed(tokens)
        c, h = self.zero_carry(tokens.shape[0]) if carry is None else carry
        xw = emb @ self.wx  # the input half of every step's gates at once
        outs = []
        for t in range(tokens.shape[1]):
            c, h = _cell(xw[:, t] + h @ self.wh + self.b, c)
            outs.append(h)
        return self.proj(torch.stack(outs, dim=1)), (c, h)


def _cell(gates: torch.Tensor, c: torch.Tensor):
    """flax's LSTM cell from its summed gates ``[..., 4H]`` (order i, f, g,
    o): ``c' = f c + i g``, ``h' = o tanh(c')``."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c2, torch.sigmoid(o) * torch.tanh(c2)


@torch.no_grad()
def init_lstm_lm(model: LstmLm, gen: torch.Generator) -> LstmLm:
    """flax's initializers, drawn from ``gen`` on the host: the embedding
    ``N(0, 1 / E)`` (``default_embed_init``), ``lecun_normal`` input and
    output kernels, an orthogonal recurrent kernel per gate, zero biases."""
    E, H = model.embed_dim, model.hidden_dim
    model.embed.weight.copy_((torch.randn(model.embed.weight.shape, generator=gen,
                                          dtype=torch.float64) / math.sqrt(E)).float())
    model.wx.copy_(torch.cat([_lecun((E, H), E, gen) for _ in range(4)], dim=1))
    model.wh.copy_(torch.cat([_orthogonal(H, gen) for _ in range(4)], dim=1))
    model.b.zero_()
    model.proj.weight.copy_(_lecun((H, model.vocab_size), H, gen).T)
    model.proj.bias.zero_()
    return model


class RnnLm(LanguageModel):
    """LSTM LM with a per-history ``(log-probabilities, carry)`` cache.

    The model runs on ``device`` (the card when None); each step's
    log-probabilities come to the host once, so :meth:`score` reads host
    memory."""

    def __init__(self, model: LstmLm, vocab: Dict[str, int], cache_size: int = 10000,
                 device=None):
        self.device = resolve(device)
        self.model = model.to(self.device).eval()
        self.vocab = dict(vocab)
        self.inv_vocab = {i: w for w, i in vocab.items()}
        self._bos = vocab.get("<s>", 0)
        self._cache: Dict[History, Tuple[np.ndarray, Tuple[torch.Tensor, torch.Tensor]]] = {}
        self._cache_size = cache_size
        #: per-epoch training losses (set by :meth:`train_from_text`)
        self.train_losses: List[float] = []

    @torch.no_grad()
    def _step(self, token: int, carry):
        with strict_precision():
            logits, new_carry = self.model(
                torch.tensor([[token]], dtype=torch.int64, device=self.device), carry)
            logp = torch.log_softmax(logits[0, 0], dim=-1)
        return logp.cpu().numpy(), new_carry

    def _state_of(self, history: History):
        """The cached state after ``history``, computing (and caching, in
        order of length) every missing prefix from the longest cached one:
        the reference's recursion, unrolled."""
        n = len(history)
        while n > 0 and history[:n] not in self._cache:
            n -= 1
        if n == 0 and () not in self._cache:
            self._insert((), self._step(self._bos, self.model.zero_carry(1)))
        for k in range(max(n, 0) + 1, len(history) + 1):
            _, carry = self._cache[history[: k - 1]]
            self._insert(history[:k], self._step(history[k - 1], carry))
        return self._cache[history]

    def _insert(self, history: History, entry) -> None:
        if len(self._cache) >= self._cache_size:
            self._cache.pop(next(iter(self._cache)))
        self._cache[history] = entry

    # ------------------------------------------------------------ LM api
    def start_history(self) -> History:
        return ()

    def extended_history(self, history: History, word: int) -> History:
        if word not in self.inv_vocab:  # OOV: fixed penalty, no context
            return tuple(history)
        return tuple(history) + (word,)

    def score(self, history: History, word: int) -> float:
        if word not in self.inv_vocab:
            return OOV_COST
        logp, _ = self._state_of(tuple(history))
        return float(-logp[word])

    def word_id(self, token: str) -> int:
        # -1 for an unknown word: it scores the fixed penalty and leaves
        # the history unchanged (no <unk> embedding is trained)
        return self.vocab.get(token, -1)

    # ------------------------------------------------------------ artifacts
    def save(self, path: str) -> None:
        """``<path>.json`` (vocab and dimensions) + ``<path>.pt`` (the
        parameters)."""
        with open(path + ".json", "w") as fh:
            json.dump({"vocab": self.vocab, "embed_dim": self.model.embed_dim,
                       "hidden_dim": self.model.hidden_dim}, fh)
        torch.save({k: v.cpu() for k, v in self.model.state_dict().items()}, path + ".pt")

    @classmethod
    def load(cls, path: str, cache_size: int = 10000, device=None) -> "RnnLm":
        with open(path + ".json") as fh:
            meta = json.load(fh)
        vocab = {w: int(i) for w, i in meta["vocab"].items()}
        model = LstmLm(len(vocab), int(meta["embed_dim"]), int(meta["hidden_dim"]))
        model.load_state_dict(torch.load(path + ".pt", map_location="cpu", weights_only=True))
        return cls(model, vocab, cache_size=cache_size, device=device)

    # ------------------------------------------------------------ training
    @classmethod
    def train_from_text(
        cls,
        sentences: Sequence[Sequence[str]],
        embed_dim: int = 32,
        hidden_dim: int = 64,
        epochs: int = 10,
        learning_rate: float = 0.05,
        seed: int = 0,
        device=None,
        init: Optional[Dict[str, torch.Tensor]] = None,
    ) -> "RnnLm":
        """Full-batch training, one Adam step per epoch (the reference's
        optax loop): cross-entropy of each next token, ``</s>``-padded and
        masked, averaged over the real positions. The parameters start from
        flax's initializers drawn from ``torch.Generator().manual_seed(seed)``,
        or from ``init`` (a ``state_dict``, e.g. the reference's draw carried
        across by ``convert.rnn_lm_from_flax``). The losses land in
        ``train_losses``."""
        device = resolve(device)
        vocab = {"<s>": 0, "</s>": 1}
        for sent in sentences:
            for tok in sent:
                vocab.setdefault(tok, len(vocab))
        seqs = [[vocab["<s>"]] + [vocab[t] for t in sent] + [vocab["</s>"]]
                for sent in sentences]
        T = max(len(s) for s in seqs)
        tokens = np.full((len(seqs), T), vocab["</s>"], np.int64)
        mask = np.zeros((len(seqs), T), np.float32)
        for i, s in enumerate(seqs):
            tokens[i, : len(s)] = s
            mask[i, 1: len(s)] = 1.0  # predict positions 1..len-1
        model = LstmLm(len(vocab), embed_dim, hidden_dim)
        if init is None:
            init_lstm_lm(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(init)
        model.to(device)
        opt = torch.optim.Adam(model.parameters(), lr=learning_rate)
        tk = torch.as_tensor(tokens, device=device)
        m = torch.as_tensor(mask[:, 1:], device=device)
        targets = tk[:, 1:]
        losses = []
        with strict_precision():
            for _ in range(epochs):
                logits, _ = model(tk[:, :-1])
                ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                                     reduction="none").reshape(targets.shape)
                loss = (ce * m).sum() / torch.clamp(m.sum(), min=1.0)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
        lm = cls(model, vocab, device=device)
        lm.train_losses = torch.stack(losses).tolist() if losses else []
        return lm
