"""PyTorch port vs JAX: the NN trainers (``train/nn_trainer.py``) and
training-state checkpoints (``train/checkpoint.py``).

Both packages start from the same flax-initialised parameters (carried
across with ``convert.nn_params_from_flax``) and see the same seeded
minibatches. Three float32 steps of SGD, SGD with momentum and Adam (with
and without coupled L2) of an FFNN, a 2-block conformer and a BLSTM (the
gates' one flax bias is its ``bias_hh``; ``bias_ih`` stays zero) leave the
parameters within 1e-5 absolute + 1e-4 relative of the JAX package's,
and the losses within 1e-5 relative. The reference's oracles
(``tests/test_nn.py``: training learns, the BLSTM sequence task, newbob,
the dev control set, the bitwise mid-epoch resume, bf16 training) run on
the port's side.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rasr_tpu.models import nn as jnn
from rasr_tpu.train import nn_trainer as jnt
from rasr_tpu_torch import convert
from rasr_tpu_torch.models import nn as tnn
from rasr_tpu_torch.train import nn_trainer as tnt
from rasr_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_nn import _toy_data

PARAM_ATOL, PARAM_RTOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
D, C = 8, 4


def _assert_params_close(model, flax_params, noise_only=(), start=None, bound=0.0):
    """Parameters within PARAM_ATOL + PARAM_RTOL of the flax tree's; those
    named in ``noise_only`` instead within ``bound`` of ``start``."""
    want = convert.nn_params_from_flax(model, jax.device_get(flax_params))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith(noise_only):
            for side in (got[k], want[k]):
                assert (side - start[k]).abs().max().item() <= bound, k
            continue
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)


def _pair(kind, dropout=0.0):
    """(flax model, port model, input of the right rank)."""
    if kind == "ffnn":
        return (jnn.FeedForwardNet(num_classes=C, hidden=(16, 8)),
                tnn.FeedForwardNet(C, D, hidden=(16, 8), dropout=dropout, device="cpu"),
                np.zeros((2, D), np.float32))
    if kind == "blstm":
        return (jnn.BlstmEncoderNet(num_classes=C, hidden=(8,)),
                tnn.BlstmEncoderNet(C, D, hidden=(8,), device="cpu"),
                np.zeros((2, 6, D), np.float32))
    kw = dict(d_model=16, num_blocks=2, num_heads=2, ff_mult=2, conv_kernel=3)
    return (jnn.ConformerEncoderNet(num_classes=C, **kw),
            tnn.ConformerEncoderNet(C, D, **kw, device="cpu"), np.zeros((2, 6, D), np.float32))


def _batches(kind, rng, n=3):
    """n minibatches of frames (ffnn) or padded utterances (the encoders)."""
    out = []
    for _ in range(n):
        if kind == "ffnn":
            x, y, _ = _toy_data(rng, n=32, D=D, M=C)
            w = rng.uniform(0.5, 1.0, size=32).astype(np.float32)
        else:
            x = rng.normal(size=(3, 11, D)).astype(np.float32)
            y = rng.integers(0, C, size=(3, 11)).astype(np.int32)
            y[1, 7:] = -1  # a shorter utterance
            w = np.ones((3, 11), np.float32)
        out.append((x, y, w))
    return out


@pytest.mark.parametrize("kind", ["ffnn", "conformer", "blstm"])
@pytest.mark.parametrize("optimizer,l2", [("sgd", 0.0), ("momentum", 0.0), ("momentum", 0.01),
                                          ("adam", 0.0), ("adam", 0.01)])
def test_three_steps_match_jax(kind, optimizer, l2):
    # Adam's first steps move each parameter by about lr x sign(gradient):
    # at its default rate of 1e-3 a gradient near 0 that rounds apart in
    # the two packages stays inside the tolerance
    lr = 1e-3 if optimizer == "adam" else 0.05
    cfg = jnt.TrainConfig(optimizer=optimizer, l2=l2, learning_rate=lr, momentum=0.9)
    jm, tm, x0 = _pair(kind)
    jcls, tcls = ((jnt.NnTrainer, tnt.NnTrainer) if kind == "ffnn"
                  else (jnt.SequenceTrainer, tnt.SequenceTrainer))
    jt = jcls(jm, C, cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x0))["params"]
    opt_state = jt.opt.init(params)
    start = convert.nn_params_from_flax(tm, params)
    tm.load_state_dict(start)
    tt = tcls(tm, C, tnt.TrainConfig(**vars(cfg)))
    steps = _batches(kind, np.random.default_rng(1))
    for x, y, w in steps:
        params, opt_state, jloss, jacc = jt._step(params, opt_state, jnp.asarray(x),
                                                  jnp.asarray(y), jnp.asarray(w))
        loss, acc = tt._update(*(torch.from_numpy(a) for a in (x, y, w)))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(acc.item(), float(jacc), atol=1e-6)
    # the attention's key bias has an identically zero gradient (softmax is
    # invariant to a shift shared by all keys); Adam scales the rounding
    # noise in it up to steps of at most lr in either package
    noise = ("mhsa.key.bias",) if optimizer == "adam" else ()
    _assert_params_close(tm, params, noise, start, len(steps) * cfg.learning_rate * 1.001)


def test_unknown_settings_raise():
    _, tm, _ = _pair("ffnn")
    with pytest.raises(ValueError, match="optimizer"):
        tnt.make_optimizer(tnt.TrainConfig(optimizer="rmsprop"), tm.parameters())
    with pytest.raises(ValueError, match="lr_schedule"):
        tnt.make_optimizer(tnt.TrainConfig(lr_schedule="cosine"), tm.parameters())


def test_newbob_step_matches_jax():
    cfg = jnt.TrainConfig(learning_rate=0.1, lr_schedule="newbob", newbob_threshold=0.05)
    _, tm, _ = _pair("ffnn")
    opt = tnt.make_optimizer(tnt.TrainConfig(**vars(cfg)), tm.parameters())
    jstate = jnt.make_optimizer(cfg).init({"w": jnp.zeros(3)})
    jprev = tprev = None
    for loss in [2.0, 1.5, 1.49, 1.2, 1.19, 1.19]:
        jstate, jprev, jlr = jnt.newbob_step(cfg, jstate, jprev, loss)
        opt, tprev, tlr = tnt.newbob_step(cfg, opt, tprev, loss)
        assert tlr == jlr and tprev == jprev
    assert np.float32(opt.param_groups[0]["lr"]) == np.float32(jstate.hyperparams["learning_rate"])


def test_frame_dataset_matches_jax(rng):
    feats = rng.normal(size=(2, 37, 4)).astype(np.float32)
    labels = rng.integers(0, 5, size=(2, 37)).astype(np.int32)
    labels[1, 30:] = -1
    weights = rng.uniform(size=(2, 37)).astype(np.float32)
    a, b = tnt.FrameDataset(feats, labels, weights), jnt.FrameDataset(feats, labels, weights)
    assert len(a) == len(b) == 67
    for got, want in zip(a.minibatches(16, 3), b.minibatches(16, 3)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(list(a.minibatches(16, 3))) == 4
    np.testing.assert_array_equal(a.label_counts(6), b.label_counts(6))


def test_train_epochs_match_jax():
    """Two epochs of the FFNN schedule (newbob on, a dev set): the same
    stats and parameters, from the same flax initialisation."""
    rng = np.random.default_rng(2)
    feats, labels, _ = _toy_data(rng, n=300, D=D, M=C)
    dev_f, dev_l, _ = _toy_data(rng, n=100, D=D, M=C)
    cfg = jnt.TrainConfig(batch_size=64, learning_rate=0.05, epochs=2, lr_schedule="newbob",
                          newbob_threshold=0.9)
    jm, tm, x0 = _pair("ffnn")
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x0))["params"]
    jp, jstats = jnt.NnTrainer(jm, C, cfg).train(
        jnt.FrameDataset(feats, labels), params=params, dev=jnt.FrameDataset(dev_f, dev_l))
    tt = tnt.NnTrainer(tm, C, tnt.TrainConfig(**vars(cfg)))
    tp, tstats = tt.train(tnt.FrameDataset(feats, labels),
                          params=convert.nn_params_from_flax(tm, params),
                          dev=tnt.FrameDataset(dev_f, dev_l))
    assert [sorted(s) for s in tstats] == [sorted(s) for s in jstats]
    for a, b in zip(tstats, jstats):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert tstats[1]["learning_rate"] == jstats[1]["learning_rate"]
    _assert_params_close(tm, jp)
    assert all(torch.equal(tp[k], v) for k, v in tm.state_dict().items())


def test_strict_precision_holds_the_backward_and_the_update(monkeypatch):
    """The update enters ``strict_precision()`` and the backward pass and
    the optimizer step run inside it (the card's TF32 defaults would
    otherwise apply to the gradients)."""
    inside, seen = [False], []

    @contextlib.contextmanager
    def counting():
        seen.append("enter")
        inside[0] = True
        try:
            yield
        finally:
            inside[0] = False

    monkeypatch.setattr(tnt, "strict_precision", counting)
    for kind in ("ffnn", "conformer"):
        _, tm, _ = _pair(kind)
        cls = tnt.NnTrainer if kind == "ffnn" else tnt.SequenceTrainer
        trainer = cls(tm, C, tnt.TrainConfig(optimizer="adam"))
        p = next(tm.parameters())
        hook = p.register_hook(lambda g: seen.append(("backward", inside[0])) or g)
        step = trainer.opt.step

        def counted_step(*a, **kw):
            seen.append(("step", inside[0]))
            return step(*a, **kw)

        trainer.opt.step = counted_step
        seen.clear()
        trainer._update(*(torch.from_numpy(a) for a in _batches(kind, np.random.default_rng(0),
                                                                  1)[0]))
        hook.remove()
        assert seen == ["enter", ("backward", True), ("step", True)], (kind, seen)


def test_dropout_draws_in_training_only():
    """With dropout > 0 the training forward keeps 1 - rate of the units
    (scaled by 1 / (1 - rate)) and draws anew per call; evaluation is
    deterministic (parity with flax holds at dropout 0, the other tests)."""
    torch.manual_seed(0)
    h = torch.ones(200_000)
    d = tnn._dropout(h, 0.3, True)
    assert abs((d != 0).float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(d[d != 0], torch.full_like(d[d != 0], 1 / 0.7))
    assert torch.equal(tnn._dropout(h, 0.3, False), h)
    _, tm, _ = _pair("ffnn", dropout=0.5)
    x = torch.randn(64, D)
    assert not torch.equal(tm(x, train=True), tm(x, train=True))
    assert torch.equal(tm(x), tm(x))
    trainer = tnt.NnTrainer(tm, C, tnt.TrainConfig())
    batch = [torch.from_numpy(a) for a in _batches("ffnn", np.random.default_rng(3), 1)[0]]
    assert trainer._loss(*batch, train=True)[0].item() != trainer._eval(*batch)[0].item()


def test_label_lengths_match_jax():
    y = np.array([[0, 1, 2, -1, -1], [3, -1, 1, 2, 0], [-1, -1, -1, -1, -1]], np.int32)
    T = y.shape[1]
    want = T - np.asarray(jnp.argmax((jnp.asarray(y) >= 0)[:, ::-1], axis=1))
    np.testing.assert_array_equal(tnt.label_lengths(torch.from_numpy(y)).numpy(), want)


# ------------------------------------ the reference's oracles, on the port
def test_training_learns(rng):
    feats, labels, _ = _toy_data(rng)
    trainer = tnt.NnTrainer(tnn.FeedForwardNet(4, D, hidden=(32,), device="cpu"), 4,
                            tnt.TrainConfig(batch_size=64, epochs=8, learning_rate=0.05))
    _, stats = trainer.train(tnt.FrameDataset(feats, labels))
    assert stats[-1]["frame_accuracy"] > 0.95
    assert stats[-1]["loss"] < stats[0]["loss"]
    priors = trainer.estimate_priors(tnt.FrameDataset(feats, labels))
    np.testing.assert_allclose(np.exp(priors.log_priors).sum(), 1.0, rtol=1e-5)


def test_blstm_sequence_training_learns(rng):
    """Label = class of the PREVIOUS frame: a recurrent encoder must
    solve it."""
    N, T, Dm, M = 48, 20, 6, 3
    means = rng.normal(size=(M, Dm)).astype(np.float32) * 3
    cls = rng.integers(0, M, size=(N, T)).astype(np.int32)
    feats = means[cls] + rng.normal(size=(N, T, Dm)).astype(np.float32) * 0.2
    labels = np.full((N, T), -1, np.int32)
    labels[:, 1:] = cls[:, :-1]
    tr = tnt.SequenceTrainer(tnn.BlstmEncoderNet(M, Dm, hidden=(16,), device="cpu"), M,
                             tnt.TrainConfig(epochs=30, learning_rate=0.01, optimizer="adam"))
    _, stats = tr.train_sequences(feats, labels, batch_size=16)
    assert stats[-1]["frame_accuracy"] > 0.9


def test_mid_epoch_checkpoint_resume_exact(tmp_path, rng):
    """An interrupted-and-resumed run reproduces the uninterrupted
    parameters bitwise (seeded permutation + full optimizer-state
    restore), under both optimizers."""
    feats, labels, _ = _toy_data(rng, n=400)
    ds = tnt.FrameDataset(feats, labels)
    for opt in ("momentum", "adam"):
        model = tnn.FeedForwardNet(4, D, hidden=(16,), device="cpu")
        cfg = tnt.TrainConfig(batch_size=64, epochs=3, learning_rate=0.05, optimizer=opt)
        straight, _ = tnt.NnTrainer(model, 4, cfg).train(ds)
        ck = CheckpointManager(str(tmp_path / opt), max_to_keep=100)
        tnt.NnTrainer(model, 4, cfg).train(ds, ckpt=ck, ckpt_every=2)
        for s in ck.all_steps():  # the job died after step 7, mid-epoch 1
            if s > 7:
                for suffix in (".pt", ".json"):
                    (tmp_path / opt / f"ckpt_{s:08d}{suffix}").unlink()
        assert ck.latest_step() == 6
        resumed, _ = tnt.NnTrainer(model, 4, cfg).train(ds, ckpt=ck, resume=True)
        for k in straight:
            assert torch.equal(straight[k], resumed[k]), (opt, k)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        ck.restore()
    for step in (3, 1, 7, 5):
        ck.save(step, {"w": torch.full((2,), float(step)), "n": step}, {"epoch": step // 2})
    assert ck.all_steps() == [5, 7] and ck.latest_step() == 7
    state, meta = ck.restore()
    assert meta == {"step": 7, "epoch": 3} and state["n"] == 7
    assert torch.equal(ck.restore(5)[0]["w"], torch.full((2,), 5.0))


def test_params_round_trip(tmp_path):
    _, tm, _ = _pair("ffnn")
    tnn.init_params(tm, 4)
    path = str(tmp_path / "params.pt")
    tnt.NnTrainer.save_params(tm.state_dict(), path)
    back = tnt.NnTrainer.load_params(path)
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())


def test_newbob_schedule_decays_on_plateau(rng):
    feats, labels, _ = _toy_data(rng)
    cfg = tnt.TrainConfig(batch_size=64, learning_rate=0.5, optimizer="sgd", epochs=6,
                          lr_schedule="newbob", newbob_decay=0.5, newbob_threshold=0.9)
    tr = tnt.NnTrainer(tnn.FeedForwardNet(4, D, hidden=(16,), device="cpu"), 4, cfg)
    _, stats = tr.train(tnt.FrameDataset(feats, labels))
    lrs = [s["learning_rate"] for s in stats if "learning_rate" in s]
    assert len(lrs) >= 3 and lrs[0] == 0.25 and lrs[1] == 0.125
    assert tr.opt.param_groups[0]["lr"] == lrs[-1]
    assert stats[-1]["frame_accuracy"] > 0.8


def test_bf16_ffnn_trains(rng):
    feats, labels, _ = _toy_data(rng)
    tr = tnt.NnTrainer(tnn.FeedForwardNet(4, D, hidden=(32,), compute_dtype="bfloat16",
                                          device="cpu"), 4,
                       tnt.TrainConfig(batch_size=64, learning_rate=0.1, epochs=4))
    _, stats = tr.train(tnt.FrameDataset(feats, labels))
    assert stats[-1]["frame_accuracy"] > 0.9
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
