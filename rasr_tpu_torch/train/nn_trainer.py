"""Supervised and sequence-discriminative NN training (hybrid DNN-HMM).

Counterpart of ``rasr_tpu/train/nn_trainer.py`` (ref: src/Nn/
FeedForwardTrainer.*, Nn::BufferedAlignedFeatureProcessor: minibatch SGD
with cross-entropy against forced-alignment labels, seeded shuffled
minibatches, L2, learning-rate schedules, state priors), in PyTorch's
idiom: the trainer updates its ``nn.Module`` in place with a
``torch.optim`` optimizer, on the module's device. The optax chains map
as follows: ``sgd`` -> ``SGD``, ``momentum`` -> ``SGD(momentum=m)``,
``adam`` -> ``Adam`` (betas 0.9 / 0.999, eps 1e-8 outside the root), and
``add_decayed_weights(l2)`` chained before the optimizer -> their coupled
``weight_decay`` (not ``AdamW``). The newbob schedule writes the
optimizer's learning rate.

Minibatch order is the reference's: numpy's ``default_rng(seed + epoch)``
permutation, so both packages see the same batches in the same order and
a run resumed mid-epoch from a checkpoint replays the rest exactly. Each
update (forward, backward and optimizer step) runs under
``models.nn.strict_precision()``: float32 products without TF32 and bf16
products reduced in float32, the reference's ``Precision.HIGHEST``. The
training forward passes ``train=True``, so a network's dropout draws
(from PyTorch's generator: parity with flax holds at dropout 0).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.nn import StatePriors, init_params, strict_precision
from ..ops.viterbi import BIG, forward_total


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 256
    learning_rate: float = 1e-3
    momentum: float = 0.9
    l2: float = 0.0
    optimizer: str = "momentum"  # sgd | momentum | adam
    epochs: int = 1
    seed: int = 0
    #: "constant", or "newbob": when the control loss (dev set if given,
    #: else train) improves by less than ``newbob_threshold`` (relative),
    #: the learning rate multiplies by ``newbob_decay`` for the following
    #: epochs.
    lr_schedule: str = "constant"
    newbob_decay: float = 0.5
    newbob_threshold: float = 0.01


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """The optimizer of ``cfg`` over ``params`` (fresh state)."""
    if cfg.lr_schedule not in ("constant", "newbob"):
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    params = list(params)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate, weight_decay=cfg.l2)
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.momentum,
                               dampening=0.0, nesterov=False, weight_decay=cfg.l2)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.l2)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def newbob_step(cfg: TrainConfig, optimizer: torch.optim.Optimizer, prev_loss, cur_loss):
    """Epoch-boundary newbob control: decay the optimizer's learning rate
    when the relative improvement of the control loss is below threshold.
    Returns (optimizer, new_prev_loss, new_lr or None)."""
    if cfg.lr_schedule != "newbob" or prev_loss is None:
        return optimizer, cur_loss, None
    rel = (prev_loss - cur_loss) / max(abs(prev_loss), 1e-12)
    if rel >= cfg.newbob_threshold:
        return optimizer, cur_loss, None
    # the reference holds the rate as a float32 array
    lr = float(np.float32(optimizer.param_groups[0]["lr"])) * cfg.newbob_decay
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer, cur_loss, lr


class FrameDataset:
    """Flattened (feature, label, weight) frames from aligned utterances,
    host numpy (the reference's buffered aligned-feature processor)."""

    def __init__(self, feats: np.ndarray, labels: np.ndarray,
                 weights: Optional[np.ndarray] = None):
        feats = np.asarray(feats)
        labels = np.asarray(labels)
        if feats.ndim == 3:
            feats = feats.reshape(-1, feats.shape[-1])
            labels = labels.reshape(-1)
            if weights is not None:
                weights = np.asarray(weights).reshape(-1)
        valid = labels >= 0
        self.feats = feats[valid].astype(np.float32)
        self.labels = labels[valid].astype(np.int32)
        self.weights = (
            weights[valid].astype(np.float32) if weights is not None
            else np.ones(self.labels.shape[0], np.float32)
        )

    def __len__(self) -> int:
        return self.labels.shape[0]

    def minibatches(self, batch_size: int, seed: int
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        perm = np.random.default_rng(seed).permutation(len(self))
        for i in range(len(self) // batch_size):
            idx = perm[i * batch_size : (i + 1) * batch_size]
            yield self.feats[idx], self.labels[idx], self.weights[idx]

    def label_counts(self, num_classes: int) -> np.ndarray:
        return np.bincount(self.labels, weights=self.weights, minlength=num_classes)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-frame CE against integer labels, in the logits' dtype."""
    C = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, C), labels.reshape(-1).to(torch.int64),
                           reduction="none").reshape(labels.shape)


class NnTrainer:
    """Frame-level CE training of ``model`` (an ``nn.Module`` of
    ``models.nn``) on its own device."""

    def __init__(self, model: nn.Module, num_classes: int, cfg: TrainConfig = TrainConfig()):
        self.model = model
        self.num_classes = num_classes
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.opt = make_optimizer(cfg, model.parameters())

    def init_params(self, seed: Optional[int] = None) -> dict:
        """New parameters from ``seed`` (``cfg.seed`` when None) with flax's
        initializers (``models.nn.init_params``); returns the state_dict."""
        init_params(self.model, self.cfg.seed if seed is None else seed)
        return self.model.state_dict()

    def _begin(self, params) -> None:
        """Load ``params`` (a state_dict; None draws new ones) and start
        a fresh optimizer state."""
        if params is None:
            self.init_params()
        else:
            self.model.load_state_dict(params)
        self.opt = make_optimizer(self.cfg, self.model.parameters())

    def _tensors(self, *arrays):
        return tuple(torch.as_tensor(a).to(self.device) for a in arrays)

    def _loss(self, x, y, w, train: bool = False):
        logits = self.model(x, train=train)
        ce = _cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).to(torch.float32)
        wsum = w.sum().clamp(min=1e-6)
        return (ce * w).sum() / wsum, (acc * w).sum() / wsum

    def _update(self, *batch):
        """One optimizer step on ``batch`` (``_loss``'s arguments), all
        of it under strict precision; returns (loss, accuracy) tensors,
        unread."""
        with strict_precision():
            self.opt.zero_grad(set_to_none=True)
            loss, acc = self._loss(*batch, train=True)
            loss.backward()
            self.opt.step()
        return loss.detach(), acc.detach()

    @torch.no_grad()
    def _eval(self, *batch):
        with strict_precision():
            return self._loss(*batch, train=False)

    def _state(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.opt.state_dict()}

    def train(
        self,
        dataset: FrameDataset,
        params=None,
        log=None,
        ckpt=None,  # train.checkpoint.CheckpointManager
        ckpt_every: int = 0,  # full-state checkpoint every N steps (0 = per epoch)
        resume: bool = False,  # restore the latest checkpoint and continue
        dev: Optional[FrameDataset] = None,  # newbob control set
    ):
        """Run the SGD schedule; optionally checkpoint / resume mid-epoch.
        Returns (a copy of the trained state_dict, per-epoch stats)."""
        self._begin(params)
        start_epoch, start_batch, gstep = 0, 0, 0
        if resume and ckpt is not None and ckpt.latest_step() is not None:
            state, meta = ckpt.restore(map_location=self.device)
            self.model.load_state_dict(state["model"])
            self.opt.load_state_dict(state["optimizer"])
            start_epoch = int(meta.get("epoch", 0))
            start_batch = int(meta.get("batch", 0))
            gstep = int(meta["step"])
            if log is not None:
                log("nn resume", epoch=start_epoch, batch=start_batch, step=gstep)
        stats = []
        prev_control = None
        for epoch in range(start_epoch, self.cfg.epochs):
            losses, accs = [], []
            skip = start_batch if epoch == start_epoch else 0
            for bi, batch in enumerate(
                dataset.minibatches(self.cfg.batch_size, self.cfg.seed + epoch)
            ):
                if bi < skip:
                    continue
                loss, acc = self._update(*self._tensors(*batch))
                losses.append(float(loss))
                accs.append(float(acc))
                gstep += 1
                if ckpt is not None and ckpt_every and gstep % ckpt_every == 0:
                    ckpt.save(gstep, self._state(), {"epoch": epoch, "batch": bi + 1})
            rec = {
                "epoch": epoch,
                "loss": float(np.mean(losses)) if losses else 0.0,
                "frame_accuracy": float(np.mean(accs)) if accs else 0.0,
            }
            if dev is not None:
                dl, da = [], []
                for batch in dev.minibatches(self.cfg.batch_size, 0):
                    loss, acc = self._eval(*self._tensors(*batch))
                    dl.append(float(loss))
                    da.append(float(acc))
                rec["dev_loss"] = float(np.mean(dl)) if dl else 0.0
                rec["dev_frame_accuracy"] = float(np.mean(da)) if da else 0.0
            control = rec.get("dev_loss", rec["loss"])
            _, prev_control, new_lr = newbob_step(self.cfg, self.opt, prev_control, control)
            if new_lr is not None:
                rec["learning_rate"] = new_lr
            stats.append(rec)
            if ckpt is not None:
                ckpt.save(gstep, self._state(), {"epoch": epoch + 1, "batch": 0})
            if log is not None:
                log("nn epoch", **rec)
        return self.save_state(), stats

    def save_state(self) -> dict:
        """A detached copy of the model's state_dict."""
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def estimate_priors(self, dataset: FrameDataset) -> StatePriors:
        return StatePriors.from_counts(dataset.label_counts(self.num_classes))

    @staticmethod
    def save_params(params: dict, path: str) -> None:
        torch.save(params, path)

    @staticmethod
    def load_params(path: str, map_location=None) -> dict:
        return torch.load(path, map_location=map_location, weights_only=True)


def label_lengths(y: torch.Tensor) -> torch.Tensor:
    """Valid length per row from the label padding (a -1 tail): T minus
    the run of trailing -1s (a row of all -1 counts as T)."""
    T = y.shape[1]
    return T - torch.argmax(torch.flip(y >= 0, dims=[1]).to(torch.uint8), dim=1)


class SequenceTrainer(NnTrainer):
    """Utterance-level trainer for length-aware encoders (BLSTM,
    conformer): minibatches are whole padded utterances ``[b, T, D]`` with
    framewise labels ``[b, T]`` (-1 on padding), CE masked over valid
    frames, the lengths from the label padding passed to the encoder."""

    def _loss(self, x, y, w, train: bool = False):
        logits = self.model(x, lengths=label_lengths(y), train=train)  # [b, T, C]
        valid = (y >= 0) & (w > 0)
        yc = y.clamp(min=0)
        ce = _cross_entropy(logits, yc)
        acc = (logits.argmax(-1) == yc).to(torch.float32)
        m = valid.to(torch.float32) * w
        msum = m.sum().clamp(min=1e-6)
        return (ce * m).sum() / msum, (acc * m).sum() / msum

    def train_sequences(self, feats: np.ndarray, labels: np.ndarray, params=None, log=None,
                        batch_size: int = 8):
        """feats [N, T, D], labels [N, T] (-1 = padding/unlabeled)."""
        feats = np.asarray(feats, np.float32)
        labels = np.asarray(labels, np.int32)
        self._begin(params)
        N = feats.shape[0]
        stats = []
        prev_control = None
        for epoch in range(self.cfg.epochs):
            perm = np.random.default_rng(self.cfg.seed + epoch).permutation(N)
            losses, accs = [], []
            for i in range(0, N - batch_size + 1, batch_size):
                sel = perm[i : i + batch_size]
                x, y = self._tensors(feats[sel], labels[sel])
                loss, acc = self._update(x, y, torch.ones(y.shape, device=self.device))
                losses.append(float(loss))
                accs.append(float(acc))
            rec = {
                "epoch": epoch,
                "loss": float(np.mean(losses)) if losses else 0.0,
                "frame_accuracy": float(np.mean(accs)) if accs else 0.0,
            }
            _, prev_control, new_lr = newbob_step(self.cfg, self.opt, prev_control, rec["loss"])
            if new_lr is not None:
                rec["learning_rate"] = new_lr
            stats.append(rec)
            if log is not None:
                log("nn sequence epoch", **rec)
        return self.save_state(), stats


class LfMmiSequenceTrainer(SequenceTrainer):
    """Sequence-discriminative NN training: the LF-MMI objective (or
    state-level sMBR) differentiated through the encoder by autograd.

    Per batch: loss = sum(num_total - den_total) / frames + ce_weight x
    framewise CE (optional anchor), or with ``criterion="smbr"`` loss =
    -sum E[frame accuracy] / frames over the denominator posterior
    (``train.lfmmi.expected_accuracy``; needs alignment labels), with
    emissions = -am_scale x log_softmax(logits). The numerator rides each
    utterance's banded linear alignment graph (``align.graph``), the
    denominator the dense phone-LM graph ``den_fsa``
    (``train.lfmmi.build_phone_bigram_den``). ``class_map`` ``[num_classes]``
    gives sMBR a coarser accuracy unit (phone-level).
    """

    def __init__(self, model: nn.Module, num_classes: int, den_fsa,
                 cfg: TrainConfig = TrainConfig(), am_scale: float = 1.0,
                 ce_weight: float = 0.0, criterion: str = "mmi", class_map=None):
        super().__init__(model, num_classes, cfg)
        if criterion not in ("mmi", "smbr"):
            raise ValueError(f"unknown sequence criterion: {criterion}")
        self.den_fsa = den_fsa.to(self.device)
        self.am_scale = am_scale
        self.ce_weight = ce_weight
        self.criterion = criterion
        self.class_map = (None if class_map is None else
                          torch.as_tensor(np.asarray(class_map), dtype=torch.int64,
                                          device=self.device))

    def _mmi_loss(self, x, y, n_frames, g_cls, g_loop, g_fwd, g_skip, g_init, g_final,
                  train: bool = False):
        from .lfmmi import dense_forward, expected_accuracy

        logits = self.model(x, lengths=n_frames, train=train)
        emis = -self.am_scale * F.log_softmax(logits, dim=-1)
        frames = n_frames.sum().clamp(min=1)
        if self.criterion == "smbr":
            acc = expected_accuracy(emis, self.den_fsa, n_frames, y, class_map=self.class_map)
            mmi = -acc.sum() / frames
        else:
            B, T, _ = emis.shape
            num_emis = emis.gather(2, g_cls[:, None, :].expand(B, T, g_cls.shape[1]))
            num_total = forward_total(num_emis, g_loop, g_fwd, g_skip, g_init, g_final,
                                      n_frames)
            den_total = dense_forward(emis, self.den_fsa, n_frames)
            mmi = (num_total - den_total).sum() / frames
        loss = mmi
        if self.ce_weight > 0.0:
            m = (y >= 0).to(torch.float32)
            ce = _cross_entropy(logits, y.clamp(min=0))
            loss = loss + self.ce_weight * (ce * m).sum() / m.sum().clamp(min=1e-6)
        return loss, mmi

    def _mmi_update(self, *batch):
        """One optimizer step of the sequence criterion on ``batch``
        (``_mmi_loss``'s arguments), under strict precision; returns
        (loss, objective) tensors, unread."""
        with strict_precision():
            self.opt.zero_grad(set_to_none=True)
            loss, mmi = self._mmi_loss(*batch, train=True)
            loss.backward()
            self.opt.step()
        return loss.detach(), mmi.detach()

    def padded_graphs(self, graphs, n: int):
        """The numerator graphs as padded ``[n, S]`` tensors on the
        trainer's device (int64 classes); 1-state dummies under sMBR,
        which never reads them."""
        from ..align.aligner import _pad_graphs

        if self.criterion == "smbr":
            big, zero = np.full((n, 1), BIG, np.float32), np.zeros((n, 1), np.float32)
            arrays = (np.zeros((n, 1), np.int64), big, big, big, zero, zero)
        else:
            arrays = _pad_graphs(graphs)
        cls, *rest = self._tensors(*arrays)
        return (cls.to(torch.int64), *rest)

    def train_lfmmi(
        self,
        feats: np.ndarray,  # [N, T, D] padded utterances
        graphs,  # numerator alignment graphs (align.graph.LinearGraph)
        n_frames: np.ndarray,  # [N]
        labels: Optional[np.ndarray] = None,  # [N, T] for sMBR and the CE anchor
        params=None,
        log=None,
        batch_size: int = 8,
    ):
        feats = np.asarray(feats, np.float32)
        n_frames = np.asarray(n_frames, np.int64)
        if labels is None:
            labels = np.full(feats.shape[:2], -1, np.int32)
        self._begin(params)
        N = feats.shape[0]
        g = self.padded_graphs(graphs, N)
        stats = []
        batch_size = min(batch_size, N)
        for epoch in range(self.cfg.epochs):
            perm = np.random.default_rng(self.cfg.seed + epoch).permutation(N)
            losses, mmis = [], []
            for i in range(0, N - batch_size + 1, batch_size):  # drop-last, as the reference
                sel = perm[i : i + batch_size]
                x, y, nf = self._tensors(feats[sel], labels[sel], n_frames[sel])
                sel_t = torch.as_tensor(sel, device=self.device)
                loss, mmi = self._mmi_update(x, y, nf, *(a[sel_t] for a in g))
                losses.append(float(loss))
                mmis.append(float(mmi))
            # under "mmi" the MMI objective per frame; under "smbr" -E[acc]/frame
            rec = {
                "epoch": epoch,
                "loss": float(np.mean(losses)),
                f"{self.criterion}_per_frame": float(np.mean(mmis)),
            }
            stats.append(rec)
            if log is not None:
                log("nn lfmmi epoch", **rec)
        return self.save_state(), stats
