"""The Zipformer hybrid acoustic model (``rasr_tpu_torch/models/zipformer.py``).

A tiny Zipformer that keeps all six stacks and five frame rates (one
layer each, widths 16-32) is held to the benchmark's plain reference
(``benchmark/reference/zipformer.py``, one utterance at a time, no masks)
in float32 and in bf16; a ragged batch through ``NnHybridScorer`` equals
each utterance scored alone; one ``SequenceTrainer`` step equals the
reference trainer's; the pieces equal hand values; ``init_params`` draws
every parameter kind; the forward records its span; and Zipformer-L,
built on the meta device, has the parameters the benchmark counts and
the paper's size.
"""

import copy
import math

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.models import zipformer as mz
from benchmark.reference import train as rtrain
from benchmark.reference import zipformer as rz
from rasr_tpu_torch.models import zipformer as zf
from rasr_tpu_torch.models.nn import NnHybridScorer, StatePriors, init_params
from rasr_tpu_torch.train.nn_trainer import SequenceTrainer, TrainConfig
from rasr_tpu_torch.utils import profiling

CLASSES = 40
CFG = spec.load_json(spec.HERE / "configs" / "zipformer-l-hybrid.json")


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread (a pool of threads costs more than
    the work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(dtype="float32"):
    cfg = copy.deepcopy(CFG)
    mz.tiny(cfg)
    cfg["zipformer"]["compute_dtype"] = dtype
    cfg["tying"]["num_classes"] = CLASSES
    return cfg


def _net(cfg, seed=3):
    w = mz.draw_zipformer(cfg, 45, CLASSES, seed, "cpu")
    return mz.net(cfg, w, "cpu"), w


@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-4),
    # bf16 products (8-bit mantissas) through six stacks of three attention
    # consumers each: ~2^-8 relative per product, logits of size ~1; the
    # largest gap over 12 seeded utterances was 0.0087 of the largest logit
    ("bfloat16", 0.03),
])
def test_port_equals_the_reference(dtype, tol):
    cfg = _tiny(dtype)
    net, w = _net(cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 72, 45)).astype(np.float32))
    got = net(x, lengths=torch.tensor([72, 40]))
    for b, L in enumerate([72, 40]):
        want = rz.logits(x[b, :L], w, cfg)
        assert (got[b, :L] - want).abs().max() < tol * max(1.0, float(want.abs().max()))


def test_a_ragged_batch_equals_each_utterance_alone():
    cfg = _tiny()
    net, _ = _net(cfg, seed=5)
    priors = StatePriors.from_counts(np.arange(1, CLASSES + 1, dtype=np.float64))
    scorer = NnHybridScorer(net, None, priors, scale=2.0, device="cpu")
    lengths = [57, 41, 64, 44]  # odd lengths: the head repeats a frame
    x = torch.randn(4, 64, 45, generator=torch.Generator().manual_seed(1))
    batch = scorer.score(x, lengths=torch.tensor(lengths))
    for b, L in enumerate(lengths):
        alone = scorer.score(x[b:b + 1, :L])
        assert (batch[b, :L] - alone[0]).abs().max() < 1e-4


def test_one_trainer_step_equals_the_reference_trainer():
    cfg = _tiny()
    net, w = _net(cfg, seed=7)
    tc = cfg["train"]
    trainer = SequenceTrainer(net, CLASSES, TrainConfig(
        optimizer="momentum", learning_rate=tc["learning_rate"], momentum=tc["momentum"], l2=0.0))
    g = torch.Generator().manual_seed(2)
    batches = [(torch.randn(2, 40, 45, generator=g), torch.randint(0, CLASSES, (2, 40), generator=g),
                torch.ones(2, 40)) for _ in range(2)]
    losses = [float(trainer._update(*b)[0]) for b in batches[:1]]
    grad = {n: trainer.opt.state[p]["momentum_buffer"].clone()
            for n, p in trainer.model.named_parameters()}
    losses.append(float(trainer._update(*batches[1])[0]))
    ref_losses, ref_grad, ref_change = rtrain.steps(rz.logits, w, batches, cfg)
    assert losses == pytest.approx(ref_losses, rel=1e-5)
    # each leaf to 1e-3 of its own largest entry, or of the median leaf's
    # where its gradient is nought to rounding (as the benchmark's check)
    med_g = float(np.median([float(g.abs().max()) for g in ref_grad.values()]))
    med_c = float(np.median([float(c.abs().max()) for c in ref_change.values()]))
    for n, p in trainer.model.named_parameters():
        tol = 1e-3 * max(float(ref_grad[n].abs().max()), med_g)
        assert (grad[n] - ref_grad[n]).abs().max() < tol, n
        # plus the rounding of the parameter itself (p - w of a float32 p)
        tol = 1e-3 * max(float(ref_change[n].abs().max()), med_c) + 2 * torch.finfo(
            torch.float32).eps * float(w[n].abs().max())
        assert (p.detach() - w[n] - ref_change[n]).abs().max() < tol, n


def test_swoosh_biasnorm_and_the_encoding_by_hand():
    z = torch.tensor([0.0, 1.0, 4.0, -3.0])
    r = [math.log1p(math.exp(v - 1)) - 0.08 * v - 0.313261687 for v in z.tolist()]
    left = [math.log1p(math.exp(v - 4)) - 0.08 * v - 0.035 for v in z.tolist()]
    assert zf.swoosh_r(z).tolist() == pytest.approx(r, abs=1e-6)
    assert zf.swoosh_l(z).tolist() == pytest.approx(left, abs=1e-6)
    assert abs(float(zf.swoosh_r(torch.tensor(0.0)))) < 1e-6  # SwooshR(0) = 0
    norm = zf.BiasNorm(2, "cpu")
    assert norm(torch.tensor([[3.0, 4.0]])).tolist()[0] == pytest.approx(
        [3 / math.sqrt(12.5), 4 / math.sqrt(12.5)])
    with torch.no_grad():
        norm.bias.fill_(1.0)
        norm.log_scale.fill_(math.log(2.0))
    assert norm(torch.tensor([[3.0, 4.0]])).tolist()[0] == pytest.approx(
        [6 / math.sqrt(6.5), 8 / math.sqrt(6.5)])
    T, dim = 8, 48
    e = zf.compact_positions(T, dim, "cpu")
    for delta in (-7, -2, 0, 1, 5):
        L = math.sqrt(dim)
        comp = L * math.copysign(1.0, delta) * (math.log(abs(delta) + L) - math.log(L))
        theta = math.atan(comp * 2 * math.pi / dim)
        want = [f((m + 1) * theta) for m in range(dim // 2) for f in (math.cos, math.sin)]
        want[-1] = 1.0
        assert e[delta + T - 1].tolist() == pytest.approx(want, abs=1e-6)


def test_down_and_up_by_hand():
    down = zf.Downsample(2, "cpu")  # weights 0: the two frames' mean
    x = torch.tensor([[[1.0], [2.0], [3.0]], [[1.0], [2.0], [3.0]]])
    assert down(x, None)[:, :, 0].tolist() == [[1.5, 3.0], [1.5, 3.0]]  # padded with the last
    assert down(x, torch.tensor([3, 2]))[:, :, 0].tolist() == [[1.5, 3.0], [1.5, 2.0]]
    stack = zf.ZipformerStack(2, 0, 1, 4, 1, 3, 4, 2, 2, 8, "cpu")  # Down, no layer, Up, bypass 0.5
    got = stack(x[:1], None, zf.Compute([], torch.float32))
    assert got[0, :, 0].tolist() == pytest.approx([0.5 * (1 + 1.5), 0.5 * (2 + 1.5), 3.0])


def test_init_params_draws_every_kind():
    cfg = _tiny()
    net, _ = _net(cfg)
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(7.0)
    trainer = SequenceTrainer(net, CLASSES, TrainConfig(optimizer="momentum"))
    params = trainer.init_params(seed=4)
    assert not any(bool((v == 7.0).any()) for v in params.values())
    assert float(params["stacks.1.downsample.weights"].abs().max()) == 0.0
    assert params["stacks.0.layers.0.bypass.scale"].eq(0.5).all()
    assert params["stacks.3.out_combiner.scale"].eq(0.5).all()
    assert float(params["embed.out_norm.log_scale"]) == 0.0
    for name, fan in (("embed.conv1.weight", 8 * 9), ("head_upsample.weight", 32 * 4)):
        std = float(params[name].std())
        assert 0.6 < std * math.sqrt(fan) < 1.4, name  # lecun: variance 1 / fan_in
    init_params(net, 4)
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in params.items())


def test_the_graphed_step_covers_every_parameter_and_runs_eagerly_on_the_cpu():
    cfg = _tiny()
    net, _ = _net(cfg)
    step = zf._Encode(net)
    assert [id(p) for p in step.parameters()] == [id(p) for p in net.parameters()]
    x, lengths = torch.randn(2, 50, 45), torch.tensor([50, 31])
    assert torch.equal(step(x, lengths), net(x, lengths=lengths))
    assert net._graph_for(x, lengths) is None and net._graphed is None


def test_a_training_shape_is_graphed_at_its_second_call_and_one_shape_at_most(monkeypatch):
    """The graphs' bookkeeping, with the card's calls faked: a shape's
    first training call warms up eagerly without touching any ``.grad``,
    captures on copies of its inputs and already replays; later calls at
    that shape replay the same graphs; a second shape stays eager."""
    import types

    cfg = _tiny()
    net, _ = _net(cfg)
    made = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "make_graphed_callables",
                        lambda step, args, num_warmup_iters: made.append((step, args)) or step)

    def card(shape):
        x = torch.randn(shape)
        return types.SimpleNamespace(is_cuda=True, shape=shape, device="cpu",
                                     detach=lambda: x)

    lengths = torch.tensor([50, 31])
    a, b = card((2, 50, 45)), card((2, 60, 45))
    step = net._graph_for(a, lengths)
    assert isinstance(step, zf._Encode) and [s for s, _ in made] == [step]
    assert all(p.grad is None for p in net.parameters())
    (x, n), = [args for _, args in made]
    assert torch.equal(x, a.detach()) and x is not a.detach() and torch.equal(n, lengths)
    assert n is not lengths
    assert net._graph_for(a, lengths) is step and len(made) == 1
    assert net._graph_for(b, lengths) is None and net._graph_for(b, lengths) is None
    assert len(made) == 1
    with torch.no_grad():
        assert net._graph_for(a, lengths) is None


def test_the_forward_records_its_span(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    cfg = _tiny()
    net, _ = _net(cfg)
    net(torch.randn(2, 50, 45))
    (sp,) = rec.records("zipformer.forward")
    z = cfg["zipformer"]
    assert sp.counts == {"frames": 100, "layer_frames": 2 * sum(
        n * -(-25 // ds) for n, ds in zip(z["num_encoder_layers"], z["downsampling_factor"]))}
    assert set(rec.report()) == {"zipformer.forward"}
    assert spec.reader("zipformer.host_us_per_step") is not None


def test_zipformer_l_has_the_counted_parameters_and_the_papers_size():
    with torch.device("meta"):
        net = zf.ZipformerEncoderNet(9001, 45, device="meta")
    got = {n: tuple(p.shape) for n, p in net.named_parameters()}
    specs = mz.zipformer_param_specs(CFG, 45, 9001)
    assert got == {n: tuple(s) for n, s, _ in specs}
    head = sum(math.prod(s) for n, s, _ in specs if n.startswith(("head_upsample", "output")))
    encoder = sum(math.prod(s) for _, s, _ in specs) - head
    assert head == 768 * 768 * 4 + 768 + 768 * 9001 + 9001  # 9.3M
    # the paper's 148.4M less the transducer's predictor and joiner at the
    # recipe's sizes (500 tokens, decoder and joiner 512): embedding 256,000,
    # decoder conv 4,096, encoder_proj 393,728, decoder_proj 262,656, output
    # 256,500, simple_am_proj 384,500, simple_lm_proj 256,500
    paper = 148.4e6 - 1_813_980
    assert abs(encoder - paper) < 0.02 * paper
