"""PyTorch port vs JAX: LF-MMI and state-level sMBR (``train/lfmmi.py``) and
the sequence-discriminative trainer (``LfMmiSequenceTrainer``).

The same seeded numpy emissions, denominator graphs and numerator graphs
go through both packages on the CPU. Tolerances: totals, LF-MMI and sMBR
losses and expected accuracies 1e-4 relative; emission gradients 1e-4
relative to the largest gradient entry (the sMBR one is a second
derivative: the reference's forward-over-reverse ``jax.jvp``, the port's
``create_graph`` backward); a trainer step's parameters 1e-5 absolute +
1e-4 relative. The reference's oracles (``tests/test_lfmmi.py``: brute
force over all paths, occupancy gradients, the finite-difference sMBR
gradient, phone-level accuracy, both trainers learning) run on the
port's side.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rasr_tpu.align import graph as jgr
from rasr_tpu.models import nn as jnn
from rasr_tpu.models.hmm import Tdp as JTdp
from rasr_tpu.models.hmm import TransitionModel as JTransitionModel
from rasr_tpu.train import lfmmi as jlf
from rasr_tpu.train import nn_trainer as jnt
from rasr_tpu_torch import convert
from rasr_tpu_torch.align import aligner as tal
from rasr_tpu_torch.align.graph import LinearGraph
from rasr_tpu_torch.models import nn as tnn
from rasr_tpu_torch.models.hmm import Tdp, TransitionModel
from rasr_tpu_torch.ops.viterbi import BIG, forward_backward
from rasr_tpu_torch.train import lfmmi as tlf
from rasr_tpu_torch.train import nn_trainer as tnt
from tests.test_lfmmi import (
    _brute_expected_accuracy, _brute_total_and_occ, _tiny_fsa,
)

RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4


def _grad_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _port_fsa(fsa):
    return convert.dense_fsa_from_jax(fsa, device="cpu")


def _den_pair(P=3, Q=2, seed=0, skip=math.inf):
    bigram = np.random.default_rng(seed).uniform(0.5, 2.0, size=(P, P)).astype(np.float32)
    kw = dict(classify=lambda p, q: p * Q + q, bigram_costs=bigram,
              unigram_costs=np.linspace(0.1, 0.5, P).astype(np.float32))
    j = jlf.build_phone_bigram_den(P, Q, trans=JTransitionModel(
        speech=JTdp(loop=0.7, forward=0.3, skip=skip, exit=0.4)), **kw)
    t = tlf.build_phone_bigram_den(P, Q, trans=TransitionModel(
        speech=Tdp(loop=0.7, forward=0.3, skip=skip, exit=0.4)), device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("skip", [math.inf, 1.5])
def test_phone_bigram_den_matches_jax(skip):
    j, t = _den_pair(P=4, Q=3, skip=skip)
    for f in ("trans", "emis_class", "init", "final"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    c = _port_fsa(j)
    assert c.emis_class.dtype == torch.int64 and torch.equal(c.trans, t.trans)
    j1 = jlf.build_phone_bigram_den(3, 2, classify=lambda p, q: p, states_of=[1, 2, 2],
                                    bigram_costs=np.ones((3, 3), np.float32))
    t1 = tlf.build_phone_bigram_den(3, 2, classify=lambda p, q: p, states_of=[1, 2, 2],
                                    bigram_costs=np.ones((3, 3), np.float32), device="cpu")
    np.testing.assert_array_equal(t1.trans.numpy(), np.asarray(j1.trans))


def _emissions(seed, B=3, T=9, M=6):
    return np.random.default_rng(seed).uniform(0.1, 3.0, size=(B, T, M)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_forward_and_gradient_match_jax(seed):
    jfsa, tfsa = _den_pair(seed=seed)
    e = _emissions(seed)
    n = np.array([9, 5, 1], np.int32)
    want, jgrad = jax.value_and_grad(
        lambda x: jlf.dense_forward(x, jfsa, jnp.asarray(n)).sum())(jnp.asarray(e))
    et = torch.from_numpy(e).requires_grad_(True)
    got = tlf.dense_forward(et, tfsa, torch.from_numpy(n))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jlf.dense_forward(jnp.asarray(e), jfsa, jnp.asarray(n))),
                               rtol=RTOL)
    got.sum().backward()
    _grad_close(et.grad.numpy(), jgrad)


def _num_graphs(B, Sg=3, classes=((0, 2, 4), (1, 3, 5), (4, 2, 0))):
    """Linear 3-state numerator chains (loop 0.7, fwd 0.3) as padded arrays."""
    cls = np.array(classes[:B], np.int32)
    loop = np.full((B, Sg), 0.7, np.float32)
    fwd = np.full((B, Sg), 0.3, np.float32)
    fwd[:, 0] = BIG
    skip = np.full((B, Sg), BIG, np.float32)
    init = np.full((B, Sg), BIG, np.float32)
    init[:, 0] = 0.0
    final = np.full((B, Sg), BIG, np.float32)
    final[:, -1] = 0.0
    return loop, fwd, skip, init, final, cls


def test_lfmmi_grad_emissions_matches_jax():
    jfsa, tfsa = _den_pair(seed=3)
    e = _emissions(3)
    n = np.array([9, 6, 4], np.int32)
    g = _num_graphs(3)
    jloss, jgrad = jlf.lfmmi_grad_emissions(jnp.asarray(e), jfsa, jnp.asarray(n),
                                            *(jnp.asarray(a) for a in g))
    tloss, tgrad = tlf.lfmmi_grad_emissions(torch.from_numpy(e), tfsa, torch.from_numpy(n),
                                            *(torch.from_numpy(a) for a in g))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
    _grad_close(tgrad.numpy(), jgrad)
    # lfmmi_loss per utterance, numerator from the same emissions
    B, T, _ = e.shape
    et = torch.from_numpy(e)
    ne = et.gather(2, torch.from_numpy(g[5]).long()[:, None, :].expand(B, T, 3))
    num = forward_backward(ne, *(torch.from_numpy(a) for a in g[:5]), torch.from_numpy(n))[0]
    jne = jnp.take_along_axis(jnp.asarray(e), jnp.asarray(g[5])[:, None, :], axis=2)
    from rasr_tpu.ops.viterbi import forward_backward as jfb
    jnum = jfb(jne, *(jnp.asarray(a) for a in g[:5]), jnp.asarray(n))[0]
    np.testing.assert_allclose(tlf.lfmmi_loss(et, num, tfsa, torch.from_numpy(n)).numpy(),
                               np.asarray(jlf.lfmmi_loss(jnp.asarray(e), jnum, jfsa,
                                                         jnp.asarray(n))), rtol=RTOL)


@pytest.mark.parametrize("phone_level", [False, True])
def test_expected_accuracy_and_gradient_match_jax(phone_level):
    jfsa, tfsa = _den_pair(seed=4)
    e = _emissions(4)
    n = np.array([9, 7, 3], np.int32)
    ref = np.random.default_rng(5).integers(-1, 6, size=(3, 9)).astype(np.int32)
    cmap = np.array([0, 0, 1, 1, 2, 2], np.int32) if phone_level else None
    jmap = None if cmap is None else jnp.asarray(cmap)
    tmap = None if cmap is None else torch.from_numpy(cmap).long()

    def jobj(x):
        return jlf.expected_accuracy(x, jfsa, jnp.asarray(n), jnp.asarray(ref), class_map=jmap)

    want = jobj(jnp.asarray(e))
    jgrad = jax.grad(lambda x: jobj(x).sum())(jnp.asarray(e))
    tfsa64 = tlf.DenseFsa(tfsa.trans.double(), tfsa.emis_class, tfsa.init.double(),
                          tfsa.final.double())
    et = torch.from_numpy(e).requires_grad_(True)
    got = tlf.expected_accuracy(et, tfsa, torch.from_numpy(n), torch.from_numpy(ref),
                                class_map=tmap)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL)
    got.sum().backward()
    grad, jgrad = et.grad.numpy(), np.asarray(jgrad)
    # the reference's forward-over-reverse gradient is NaN at frame 0 when
    # denominator states start at BIG (every phone of more than one state);
    # the port's is finite there, and held to central differences instead
    assert np.isnan(jgrad[:, 0]).all() and np.isfinite(jgrad[:, 1:]).all()
    assert np.isfinite(grad).all()
    _grad_close(grad[:, 1:], jgrad[:, 1:])
    eps = 1e-2
    for b, m in [(0, 0), (1, 2), (2, 4)]:
        ep, em = e.copy(), e.copy()
        ep[b, 0, m] += eps
        em[b, 0, m] -= eps
        fd = [tlf.expected_accuracy(torch.from_numpy(x).double(), tfsa64, n, ref,
                                    class_map=tmap).sum().item() for x in (ep, em)]
        np.testing.assert_allclose(grad[b, 0, m], (fd[0] - fd[1]) / (2 * eps), rtol=1e-3,
                                   atol=1e-5)
    # without a graph to differentiate (evaluation), the same value
    with torch.no_grad():
        again = tlf.expected_accuracy(torch.from_numpy(e), tfsa, n, ref, class_map=tmap)
    np.testing.assert_allclose(again.numpy(), got.detach().numpy(), rtol=1e-6)


def _trainer_data(rng, N=4, T=10, D=5, P=3):
    """Separable toy utterances over P one-state phones, their numerator
    graphs (both packages) and alignment labels."""
    means = np.eye(P, D) * 2.0
    feats = np.zeros((N, T, D), np.float32)
    labels = np.zeros((N, T), np.int32)
    tgraphs, jgraphs = [], []
    for i in range(N):
        seq = [0, 1, 2] if i % 2 == 0 else [2, 1, 0]
        bounds = [0, 3 + i % 2, 7, T]
        for s, ph in enumerate(seq):
            labels[i, bounds[s]:bounds[s + 1]] = ph
        feats[i] = means[labels[i]] + 0.3 * rng.normal(size=(T, D))
        arrays = dict(
            emission_ids=np.asarray(seq, np.int32), loop=np.full(3, 0.7, np.float32),
            fwd=np.array([BIG, 0.3, 0.3], np.float32), skip=np.full(3, BIG, np.float32),
            init=np.array([0, BIG, BIG], np.float32), final=np.array([BIG, BIG, 0], np.float32),
            lemma_of_state=np.full(3, -1, np.int32))
        tgraphs.append(LinearGraph(states=[], lemmas=[], **arrays))
        jgraphs.append(jgr.LinearGraph(states=[], lemmas=[], **arrays))
    labels[1, 8:] = -1  # unscored frames
    return feats, labels, tgraphs, jgraphs


def _dens(P=3):
    kw = dict(classify=lambda p, q: p, bigram_costs=np.full((P, P), math.log(P), np.float32))
    return (jlf.build_phone_bigram_den(P, 1, trans=JTransitionModel(
                speech=JTdp(loop=0.7, forward=0.3, skip=math.inf, exit=0.0)), **kw),
            tlf.build_phone_bigram_den(P, 1, trans=TransitionModel(
                speech=Tdp(loop=0.7, forward=0.3, skip=math.inf, exit=0.0)),
                device="cpu", **kw))


@pytest.mark.parametrize("criterion,ce_weight,class_map", [
    ("mmi", 0.0, None), ("mmi", 0.5, None), ("smbr", 0.0, None), ("smbr", 0.3, [0, 1, 1])])
def test_trainer_steps_match_jax(criterion, ce_weight, class_map):
    """Two sequence-criterion steps of a float32 conformer (SGD with
    momentum): the same losses and parameters as the JAX trainer."""
    rng = np.random.default_rng(6)
    feats, labels, tgraphs, jgraphs = _trainer_data(rng)
    n = np.array([10, 10, 9, 10], np.int64)
    jden, tden = _dens()
    kw = dict(d_model=8, num_blocks=2, num_heads=2, ff_mult=2, conv_kernel=3)
    jm = jnn.ConformerEncoderNet(num_classes=3, **kw)
    tm = tnn.ConformerEncoderNet(3, 5, **kw, device="cpu")
    cfg = jnt.TrainConfig(learning_rate=0.05, optimizer="momentum")
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(feats[:2]),
                     lengths=jnp.asarray(n[:2]))["params"]
    tm.load_state_dict(convert.nn_params_from_flax(tm, params))
    jt = jnt.LfMmiSequenceTrainer(jm, 3, jden, cfg, am_scale=0.8, ce_weight=ce_weight,
                                  criterion=criterion, class_map=class_map)
    tt = tnt.LfMmiSequenceTrainer(tm, 3, tden, tnt.TrainConfig(**vars(cfg)), am_scale=0.8,
                                  ce_weight=ce_weight, criterion=criterion, class_map=class_map)
    opt_state = jt.opt.init(params)
    from rasr_tpu.align.aligner import _pad_graphs as jpad
    jg = tuple(jnp.asarray(a) for a in jpad(jgraphs))
    tg = tt.padded_graphs(tgraphs, 4)
    for sel in ([0, 1], [2, 3]):
        params, opt_state, jloss, jmmi = jt._mmi_step(
            params, opt_state, jnp.asarray(feats[sel]), jnp.asarray(labels[sel]),
            jnp.asarray(n[sel].astype(np.int32)), *(a[np.array(sel)] for a in jg))
        st = torch.tensor(sel)
        loss, mmi = tt._mmi_update(torch.from_numpy(feats[sel]), torch.from_numpy(labels[sel]),
                                   torch.from_numpy(n[sel]), *(a[st] for a in tg))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
        np.testing.assert_allclose(mmi.item(), float(jmmi), rtol=RTOL)
    want = convert.nn_params_from_flax(tm, jax.device_get(params))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=k)


def test_unknown_criterion_raises():
    _, tden = _dens()
    with pytest.raises(ValueError, match="criterion"):
        tnt.LfMmiSequenceTrainer(tnn.BlstmEncoderNet(3, 5, hidden=(4,), device="cpu"), 3, tden,
                                 criterion="mpe")


# ------------------------------------ the reference's oracles, on the port
def test_dense_forward_matches_brute_force(rng):
    T, M = 4, 4
    fsa = _tiny_fsa(rng)
    emis = rng.uniform(0.1, 3.0, size=(2, T + 1, M)).astype(np.float32)
    n = np.array([T, T - 1])
    et = torch.from_numpy(emis).requires_grad_(True)
    total = tlf.dense_forward(et, _port_fsa(fsa), torch.from_numpy(n))
    for b in range(2):
        ref, occ = _brute_total_and_occ(fsa, emis[b], int(n[b]), M)
        np.testing.assert_allclose(total[b].item(), ref, rtol=1e-5)
    total[0].backward()
    _, occ = _brute_total_and_occ(fsa, emis[0], T, M)
    np.testing.assert_allclose(et.grad[0, :T].numpy(), occ, rtol=2e-4, atol=1e-6)
    assert et.grad[0, T:].abs().sum().item() == 0.0


def test_lfmmi_gradient_is_posterior_difference(rng):
    P, Q, M, T = 2, 2, 4, 5
    den = tlf.build_phone_bigram_den(
        P, Q, classify=lambda p, q: p * Q + q,
        bigram_costs=rng.uniform(0.5, 2.0, size=(P, P)).astype(np.float32),
        trans=TransitionModel(speech=Tdp(loop=0.7, forward=0.3, skip=math.inf, exit=0.4)),
        device="cpu")
    emis = rng.uniform(0.1, 3.0, size=(1, T, M)).astype(np.float32)
    loop, fwd, skip, init, final, cls = _num_graphs(1, classes=((0, 1, 2),))
    loss, grad = tlf.lfmmi_grad_emissions(
        torch.from_numpy(emis), den, torch.tensor([T]),
        *(torch.from_numpy(a) for a in (loop, fwd, skip, init, final, cls)))
    _, den_occ = _brute_total_and_occ(den, emis[0], T, M)
    tr = np.full((3, 3), BIG, np.float32)
    for s in range(3):
        tr[s, s] = 0.7
        if s + 1 < 3:
            tr[s, s + 1] = 0.3
    num_fsa = tlf.DenseFsa(torch.from_numpy(tr), torch.tensor([0, 1, 2]),
                           torch.tensor([0.0, BIG, BIG]), torch.tensor([BIG, BIG, 0.0]))
    _, num_occ = _brute_total_and_occ(num_fsa, emis[0], T, M)
    np.testing.assert_allclose(grad[0].numpy(), num_occ - den_occ, rtol=2e-3, atol=2e-5)
    assert np.isfinite(loss.item())


def test_expected_accuracy_matches_brute_force_and_finite_differences(rng):
    T, M = 5, 4
    jfsa = _tiny_fsa(rng)
    fsa = _port_fsa(jfsa)
    emis = rng.uniform(0.1, 3.0, size=(2, T, M)).astype(np.float32)
    ref = np.array([[0, 1, 3, -1, 0], [3, 3, 0, 1, 1]], np.int32)
    n = np.array([5, 3])
    acc = tlf.expected_accuracy(torch.from_numpy(emis), fsa, n, torch.from_numpy(ref))
    for b in range(2):
        want = _brute_expected_accuracy(jfsa, emis[b], int(n[b]), ref[b])
        np.testing.assert_allclose(acc[b].item(), want, rtol=1e-4)
    # the training gradient against central finite differences
    e1 = emis[:1, :4].copy()
    ref1 = torch.tensor([[0, 3, 1, 0]])

    def obj(x):
        return tlf.expected_accuracy(x, fsa, torch.tensor([4]), ref1)[0]

    et = torch.from_numpy(e1).double().requires_grad_(True)
    fsa64 = tlf.DenseFsa(fsa.trans.double(), fsa.emis_class, fsa.init.double(),
                         fsa.final.double())

    def obj64(x):
        return tlf.expected_accuracy(x, fsa64, torch.tensor([4]), ref1)[0]

    obj64(et).backward()
    eps = 1e-3
    for t, m in [(0, 0), (1, 3), (2, 1), (3, 2)]:
        ep, em = e1.copy(), e1.copy()
        ep[0, t, m] += eps
        em[0, t, m] -= eps
        fd = (obj(torch.from_numpy(ep)).item() - obj(torch.from_numpy(em)).item()) / (2 * eps)
        np.testing.assert_allclose(et.grad[0, t, m].item(), fd, rtol=2e-2, atol=1e-4)
    e32 = torch.from_numpy(e1).requires_grad_(True)
    obj(e32).backward()
    np.testing.assert_allclose(e32.grad.numpy(), et.grad.numpy(), rtol=1e-3, atol=1e-5)


def test_expected_accuracy_phone_level_is_coarser(rng):
    T, M = 4, 4
    fsa = _port_fsa(_tiny_fsa(rng))
    emis = torch.from_numpy(rng.uniform(0.1, 3.0, size=(1, T, M)).astype(np.float32))
    ref = torch.tensor([[0, 1, 3, 0]])
    fine = tlf.expected_accuracy(emis, fsa, [T], ref)
    coarse = tlf.expected_accuracy(emis, fsa, [T], ref, class_map=torch.tensor([0, 0, 1, 1]))
    assert coarse.item() >= fine.item() - 1e-5


def test_lfmmi_sequence_trainer_learns(rng):
    """LF-MMI through a BLSTM: the objective falls and the true
    transcript's numerator out-scores the reversed one."""
    feats, labels, graphs, _ = _trainer_data(rng, N=8, T=18, D=4)
    _, den = _dens()
    model = tnn.BlstmEncoderNet(3, 4, hidden=(8,), device="cpu")
    trainer = tnt.LfMmiSequenceTrainer(
        model, 3, den, cfg=tnt.TrainConfig(epochs=30, learning_rate=0.01, optimizer="adam"))
    n = np.full(8, 18)
    _, stats = trainer.train_lfmmi(feats, graphs, n, batch_size=4)
    assert stats[-1]["mmi_per_frame"] < stats[0]["mmi_per_frame"] - 0.1
    with torch.no_grad():
        emis = -torch.log_softmax(model(torch.from_numpy(feats), lengths=torch.from_numpy(n)), -1)

    def totals(gs):
        cls, loop, fwd, skip, init, final = (torch.from_numpy(a) for a in tal._pad_graphs(gs))
        ne = emis.gather(2, cls.long()[:, None, :].expand(8, 18, cls.shape[1]))
        return forward_backward(ne, loop, fwd, skip, init, final, torch.from_numpy(n))[0]

    rivals = [graphs[i + 1] if i % 2 == 0 else graphs[i - 1] for i in range(8)]
    assert (totals(graphs) < totals(rivals)).sum().item() >= 7


def test_smbr_sequence_trainer_learns(rng):
    feats, labels, graphs, _ = _trainer_data(rng, N=8, T=12, D=4)
    _, den = _dens()
    model = tnn.BlstmEncoderNet(3, 4, hidden=(8,), device="cpu")
    trainer = tnt.LfMmiSequenceTrainer(
        model, 3, den, cfg=tnt.TrainConfig(epochs=25, learning_rate=0.01, optimizer="adam"),
        criterion="smbr")
    n = np.full(8, 12)
    _, stats = trainer.train_lfmmi(feats, graphs, n, labels=labels, batch_size=4)
    assert stats[-1]["smbr_per_frame"] < stats[0]["smbr_per_frame"] - 0.15
    with torch.no_grad():
        emis = -torch.log_softmax(model(torch.from_numpy(feats), lengths=torch.from_numpy(n)), -1)
    acc = tlf.expected_accuracy(emis, den, n, torch.from_numpy(labels))
    assert acc.mean().item() / 12 > 0.75
