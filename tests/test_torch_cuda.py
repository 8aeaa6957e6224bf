"""The port's CUDA kernels against their plain versions, on the card.

The tests marked ``cuda`` need an NVIDIA card and skip without one. This
file imports no jax, so on the card's machine (which has none) it runs
without the repository's conftest:

    python -m pytest --noconftest -o addopts= -p no:cacheprovider tests/test_torch_cuda.py

The unmarked tests check what holds without a card: the smoke script
and ``cuda_device`` refuse to carry on on the CPU.
"""

import dataclasses
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from rasr_tpu_torch import _build  # noqa: E402
from rasr_tpu_torch.device import cuda_device  # noqa: E402
from rasr_tpu_torch.models.gmm import MixtureSet, make_scoring_tensors  # noqa: E402
from rasr_tpu_torch.fsa.automaton import Automaton  # noqa: E402
from rasr_tpu_torch.ops.frontend import (  # noqa: E402
    FeatureFrontend, FrontendConfig, frame_signal, make_params, num_frames, power_spectrum,
    preemphasize,
)
from rasr_tpu_torch.ops.gammatone import (  # noqa: E402
    GammatoneConfig, GammatoneFrontend, piecewise_linear_warp,
)
from rasr_tpu_torch.ops.kernels.gmm import gmm_scores, gmm_scores_plain  # noqa: E402
from rasr_tpu_torch.ops.kernels.mfcc import (  # noqa: E402
    folded_bases, mfcc_frames, mfcc_frames_plain, pack_basis,
)
from rasr_tpu_torch.ops.kernels.row_gather import row_gather, row_gather_plain  # noqa: E402
from rasr_tpu_torch.ops.kernels.wordend import (  # noqa: E402
    WORD_NONE, wordend_block, wordend_block_plain,
)
from rasr_tpu_torch.examples import gather_microbench, wordend_microbench  # noqa: E402
from rasr_tpu_torch.models.lm.ngram import compile_ngram  # noqa: E402
from rasr_tpu_torch.models.nn import (  # noqa: E402
    BlstmEncoderNet, ConformerEncoderNet, init_params,
)
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder  # noqa: E402
from rasr_tpu_torch.search.lookahead import build_bigram_lookahead  # noqa: E402
from rasr_tpu_torch.search.wfst import compile_wfst  # noqa: E402
from rasr_tpu_torch.models.lm.rnn import RnnLm  # noqa: E402
from rasr_tpu_torch.search.rnn_fusion import build_rnn_fusion  # noqa: E402
from rasr_tpu_torch.search.streaming import StreamingDecoder  # noqa: E402
from rasr_tpu_torch.synthetic import PATHS, build_setup  # noqa: E402
from rasr_tpu_torch.align.aligner import BatchAligner  # noqa: E402
from rasr_tpu_torch.align.graph import build_linear_graph  # noqa: E402
from rasr_tpu_torch.models.hmm import HmmTopology  # noqa: E402
from rasr_tpu_torch.ops.viterbi import BIG  # noqa: E402
from rasr_tpu_torch.train import lfmmi  # noqa: E402
from rasr_tpu_torch.train.nn_trainer import SequenceTrainer, TrainConfig  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cuda_device()


def _mixtures(rng, M, K, D):
    ms = MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 1.0 / K, np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    ms.num_densities[3] = 1
    ms.weights[3] = np.eye(1, K, dtype=np.float32)[0]
    return ms


@pytest.mark.cuda
@pytest.mark.parametrize("max_approx", [True, False])
@pytest.mark.parametrize("N,M,K,D", [(1000, 70, 3, 45), (5, 13, 2, 9), (300, 129, 8, 17),
                                     (257, 65, 2, 64), (130, 66, 3, 80), (257, 65, 2, 96),
                                     (140, 70, 3, 150)])
def test_gmm_kernel_matches_plain(card, max_approx, N, M, K, D):
    """Ragged frame / mixture / feature edges; fp32 sums in another order.
    D > 48 streams each density's depth in several chunks; D = 80 is the
    largest resident frame tile, and deeper models stream the frames too."""
    rng = np.random.default_rng(N + M)
    st = make_scoring_tensors(_mixtures(rng, M, K, D), device=card)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(card)
    before = gmm_scores.launches
    got = gmm_scores(x, st, max_approx)
    torch.cuda.synchronize()
    assert gmm_scores.launches == before + 1
    torch.testing.assert_close(got, gmm_scores_plain(x, st, max_approx), rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,fft,num_mel", [(3, 16000, 0, 20), (1, 1200, 0, 20),
                                             (2, 4321, 1024, 20), (3, 16000, 0, 40),
                                             (2, 4321, 0, 80)])
def test_mfcc_kernel_matches_plain(card, B, S, fft, num_mel):
    """Strided frame views of the signal, frame counts off the tile, more
    bins than one thread block has threads (1024-point FFT), and more mel
    bands than one group of 32 (at 80 the frames are read from global
    memory: the staged span no longer fits beside the mel rows)."""
    cfg = FrontendConfig(fft_size=fft, num_mel=num_mel)
    p = make_params(cfg, card)
    cosw, sinw = folded_bases(p)
    basis = pack_basis(cosw, sinw)
    rng = np.random.default_rng(S)
    sig = torch.from_numpy((rng.normal(size=(B, S)) * 0.1).astype(np.float32)).to(card)
    frames = frame_signal(preemphasize(sig, cfg.preemphasis), num_frames(S, cfg), cfg)
    got = mfcc_frames(frames, cosw, sinw, p.mel, p.dct, cfg.log_floor, basis)
    want = mfcc_frames_plain(frames, cosw, sinw, p.mel, p.dct, cfg.log_floor)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    flat = mfcc_frames(frames.reshape(-1, cfg.frame_length).contiguous(), cosw, sinw,
                       p.mel, p.dct, cfg.log_floor, basis)
    torch.testing.assert_close(flat.reshape(got.shape), got, rtol=0, atol=0)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    rng = np.random.default_rng(0)
    st = make_scoring_tensors(_mixtures(rng, 8, 2, 5), device=card)
    x = torch.zeros((4, 5), device=card)
    with pytest.raises(TypeError):
        gmm_scores(x.double(), st)
    with pytest.raises(ValueError):
        gmm_scores(torch.zeros((4, 6), device=card), st)
    with pytest.raises(ValueError):
        gmm_scores(torch.zeros((5, 4), device=card).T, st)
    cfg = FrontendConfig()
    p = make_params(cfg, card)
    cosw, sinw = folded_bases(p)
    basis = pack_basis(cosw, sinw)
    with pytest.raises(ValueError):
        mfcc_frames(torch.zeros((2, 399), device=card), cosw, sinw, p.mel, p.dct, 1e-10, basis)
    with pytest.raises(ValueError):
        mfcc_frames(torch.zeros((2, 400), device=card), cosw, sinw, p.mel, p.dct, 1e-10,
                    basis[:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    wordend_microbench.SHAPE,
    dict(B=3, KW=1000, S1=5003, C=1999, C_sp=12),  # ragged KW and C
    dict(B=5, KW=7, S1=11, C=3, C_sp=5),  # fewer slots than a block has threads
    dict(B=2, KW=300, S1=64, C=9, C_sp=0),  # no state-pack columns
])
def test_wordend_kernel_matches_plain(card, shape):
    """Bit-equal: two fp32 adds in the same order, no multiply to contract."""
    w_state, w_score, combo, emis = wordend_microbench.make_inputs(**shape)
    combo[w_state[0, 0], 0] = WORD_NONE
    args = [torch.from_numpy(x).to(card) for x in (w_state, w_score, combo, emis)]
    before = wordend_block.launches
    got = wordend_block(*args, shape["C_sp"])
    torch.cuda.synchronize()
    assert wordend_block.launches == before + 1
    want = wordend_block_plain(*args, shape["C_sp"])
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    assert got[0][0, 0].item() == float(np.float32(1e30))


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,N", [(56432, 16, 65536), (1000, 5, 777), (300, 8, 1), (50, 4, 0)])
def test_row_gather_kernel_matches_plain(card, S, C, N):
    """The int4 path (C % 4 == 0), the scalar path, and an empty gather."""
    table, idx = (torch.from_numpy(x).to(card)
                  for x in gather_microbench.make_inputs(S, C, N, seed=C))
    before = row_gather.launches
    got = row_gather(table, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + (1 if N else 0)
    assert torch.equal(got, row_gather_plain(table, idx))


@pytest.mark.cuda
def test_gather_wrappers_raise_on_what_the_kernels_do_not_take(card):
    w_state, w_score, combo, emis = (
        torch.from_numpy(x).to(card) for x in wordend_microbench.make_inputs(2, 8, 20, 12, 4))
    with pytest.raises(TypeError):
        wordend_block(w_state.long(), w_score, combo, emis, 4)
    with pytest.raises(ValueError):
        wordend_block(w_state, w_score.cpu(), combo, emis, 4)
    with pytest.raises(ValueError):
        wordend_block(w_state, w_score, combo, emis, 17)
    table, idx = (torch.from_numpy(x).to(card) for x in gather_microbench.make_inputs(10, 4, 6))
    with pytest.raises(TypeError):
        row_gather(table.float(), idx)
    with pytest.raises(ValueError):
        row_gather(table, idx.cpu())
    with pytest.raises(ValueError):
        row_gather(table.T, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("slice_b", [False, True])
def test_slice_on_card_equals_cpu(card, slice_b):
    """Slice A's pruning, and slice B's: root select, deferred emission
    and the root-arc cap at a scaled-down production beam."""
    beam = BeamConfig(max_hyps=64, word_end_limit=16, root_hyps=4, branch_hyps=16,
                      lm_scale=10.0)
    if slice_b:
        beam = dataclasses.replace(beam, root_arc_limit=12, root_select=48,
                                   deferred_emission=True)
    kw = dict(num_words=80, num_phones=12, num_classes=150, densities=4, beam=beam)
    on_card, on_cpu = build_setup(device=card, **kw), build_setup(**kw, device="cpu")
    x = torch.from_numpy((np.random.default_rng(3).normal(size=(3, 12000)) * 0.1)
                         .astype(np.float32))
    lengths = torch.tensor([12000, 9000, 5000])
    f_card, n_card = on_card.frontend(x.to(card), lengths.to(card))
    f_cpu, n_cpu = on_cpu.frontend(x, lengths)
    torch.testing.assert_close(f_card.cpu(), f_cpu, rtol=1e-3, atol=1e-3)
    e_card = on_card.scorer(f_card)
    torch.testing.assert_close(e_card.cpu(), on_cpu.scorer(f_cpu), rtol=1e-4, atol=1e-2)
    a = on_card.decoder.decode_scores(e_card, n_card)
    b = on_cpu.decoder.decode_scores(e_card.cpu(), n_cpu)
    assert [r.words for r in a] == [r.words for r in b]
    np.testing.assert_allclose([r.score for r in a], [r.score for r in b], rtol=1e-5)


#: compact slots for chip_smoke.py's two slice-C paths at a scaled-down
#: size, which the 16 branch hyps' fans overflow
SLICE_C_WIDTH = {"across-word": 96, "4-gram": 24}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(SLICE_C_WIDTH))
def test_slice_c_path_on_card_equals_cpu(card, path):
    """One setup built once; its decoder on the card and a decoder of the
    same network, LM and lookahead on the CPU decode the same scores."""
    beam = BeamConfig(max_hyps=64, word_end_limit=16, root_hyps=4, branch_hyps=16,
                      root_arc_limit=12, root_select=48, deferred_emission=True, lm_scale=10.0)
    s = build_setup(num_words=80, num_phones=12, num_classes=150, densities=4, beam=beam,
                    device=card, **dict(PATHS[path], branch_width=SLICE_C_WIDTH[path]))
    on_cpu = TreeDecoder(s.tree, compile_ngram(s.lm), s.beam, bigram_la=s.bigram_la,
                         device="cpu")
    x = torch.from_numpy((np.random.default_rng(5).normal(size=(3, 12000)) * 0.1)
                         .astype(np.float32)).to(card)
    feats, n = s.frontend(x, torch.tensor([12000, 9000, 5000], device=card))
    e = s.scorer(feats)
    a = s.decoder.decode_scores(e, n)
    b = on_cpu.decode_scores(e.cpu(), n.cpu())
    assert all(r.words for r in b)
    assert [r.words for r in a] == [r.words for r in b]
    np.testing.assert_allclose([r.score for r in a], [r.score for r in b], rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conformer_on_card_equals_cpu(card, dtype):
    """The same weights on the card and on the CPU, ragged lengths
    (valid frames compared): float32 without TF32 to float32 rounding;
    bf16 within a few bf16 ulps of logits within |5| (the card's and the
    CPU's products round the same sums taken in other orders)."""
    kw = dict(d_model=64, num_blocks=2, num_heads=4, conv_kernel=15, compute_dtype=dtype)
    on_cpu = init_params(ConformerEncoderNet(40, 45, device="cpu", **kw), 2)
    on_card = ConformerEncoderNet(40, 45, device=card, **kw)
    on_card.load_state_dict(on_cpu.state_dict())
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 120, 45)).astype(np.float32))
    lengths = torch.tensor([120, 77, 31])
    with torch.no_grad():
        got = on_card(x.to(card), lengths=lengths.to(card)).cpu()
        want = on_cpu(x, lengths=lengths)
    valid = torch.arange(120)[None, :] < lengths[:, None]
    assert bool(torch.isfinite(got).all())
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0, atol=0.0625)
    torch.testing.assert_close(got[valid], want[valid], **tol)


@pytest.mark.cuda
def test_blstm_on_card_equals_cpu(card):
    """cuDNN's packed bidirectional LSTM against the CPU's, ragged lengths."""
    on_cpu = init_params(BlstmEncoderNet(30, 45, hidden=(64, 32), device="cpu"), 5)
    on_card = BlstmEncoderNet(30, 45, hidden=(64, 32), device=card)
    on_card.load_state_dict(on_cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 90, 45)).astype(np.float32))
    lengths = torch.tensor([90, 61, 7])
    with torch.no_grad():
        got = on_card(x.to(card), lengths=lengths).cpu()
        want = on_cpu(x, lengths=lengths)
    valid = torch.arange(90)[None, :] < lengths[:, None]
    torch.testing.assert_close(got[valid], want[valid], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_streamed_equals_offline_on_card(card):
    """Blocks of 16 frames (the last one short) over ragged declared
    lengths under the scaled-down production beam: the offline results."""
    beam = BeamConfig(max_hyps=64, word_end_limit=16, root_hyps=4, branch_hyps=16,
                      root_arc_limit=12, root_select=48, deferred_emission=True, lm_scale=10.0)
    s = build_setup(num_words=80, num_phones=12, num_classes=150, densities=4, beam=beam,
                    device=card)
    x = torch.from_numpy((np.random.default_rng(7).normal(size=(3, 12000)) * 0.1)
                         .astype(np.float32)).to(card)
    feats, n = s.frontend(x, torch.tensor([12000, 9000, 5000], device=card))
    e = s.scorer(feats)
    want = s.decoder.decode_scores(e, n)
    sd = StreamingDecoder(s.decoder).restart(3, n)
    for lo in range(0, e.shape[1], 16):
        sd.feed(e[:, lo:lo + 16])
    got = sd.finalize()
    assert [r.words for r in got] == [r.words for r in want]
    assert [r.word_ends for r in got] == [r.word_ends for r in want]
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["viterbi", "baum-welch"])
def test_aligner_on_card_equals_cpu(card, mode):
    """Forced alignment of the same GMM scores (the fused kernel's, on the
    card) on the card and on the CPU: the same float ops, so the same
    state sequences; scores 1e-5 relative, posteriors 1e-5 absolute."""
    s = build_setup(num_words=80, num_phones=12, num_classes=150, densities=4, device=card)
    rng = np.random.default_rng(8)
    words = [l.primary_orth for l in s.lexicon.lemmata if not l.special]
    topo = HmmTopology(states_per_phone=3, silence_states=1)
    graphs = [build_linear_graph(" ".join(rng.choice(words, size=int(k))), s.lexicon, s.tying,
                                 topo) for k in (3, 5, 2, 4)]
    x = torch.from_numpy((rng.normal(size=(4, 24000)) * 0.1).astype(np.float32)).to(card)
    feats, n = s.frontend(x, torch.tensor([24000, 24000, 12000, 20000], device=card))
    before = gmm_scores.launches
    scores = s.scorer(feats)
    assert gmm_scores.launches == before + 1
    aligner = BatchAligner(s.scorer, mode)
    got = aligner.align_scores(scores, graphs, n)
    want = aligner.align_scores(scores.cpu(), graphs, n.cpu())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.state_indices, b.state_indices)
        np.testing.assert_allclose(a.score, b.score, rtol=1e-5)
        np.testing.assert_allclose(a.weights, b.weights, atol=1e-5)
    assert all(np.isfinite(a.score) and a.score < BIG / 2 for a in got)


def _conformer_pair(card, seed=2):
    kw = dict(d_model=64, num_blocks=2, num_heads=4, conv_kernel=15)
    on_cpu = init_params(ConformerEncoderNet(40, 45, device="cpu", **kw), seed)
    on_card = ConformerEncoderNet(40, 45, device=card, **kw)
    on_card.load_state_dict(on_cpu.state_dict())
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 100, 45)).astype(np.float32)
    y = rng.integers(0, 40, size=(3, 100)).astype(np.int32)
    y[2, 60:] = -1
    return on_cpu, on_card, (x, y, np.ones((3, 100), np.float32))


@pytest.mark.cuda
def test_conformer_train_step_on_card_equals_cpu(card):
    """One float32 SequenceTrainer step (momentum) of the same conformer
    on the card and on the CPU: parameters within 1e-4 + 1e-3 relative."""
    on_cpu, on_card, batch = _conformer_pair(card)
    for net, dev in ((on_cpu, "cpu"), (on_card, card)):
        tr = SequenceTrainer(net, 40, TrainConfig(learning_rate=0.05))
        tr._update(*(torch.from_numpy(a).to(dev) for a in batch))
    want = on_cpu.state_dict()
    for k, v in on_card.state_dict().items():
        torch.testing.assert_close(v.cpu(), want[k], rtol=1e-3, atol=1e-4, msg=k)


@pytest.mark.cuda
def test_train_step_holds_strict_precision_on_card(card):
    """With TF32 allowed globally (PyTorch's convolution default, and
    matmul's when a caller turns it on), one conformer step's gradients
    equal those of the same step with TF32 forbidden: the backward runs
    under strict precision. The same backward taken outside strict
    precision moves by TF32's rounding, so the check can tell."""
    _, net, batch = _conformer_pair(card, seed=3)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    batch = [torch.from_numpy(a).to(card) for a in batch]
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)

    def grads(tf32: bool, strict: bool = True):
        net.load_state_dict(start)
        tr = SequenceTrainer(net, 40, TrainConfig(learning_rate=0.0))
        mm.allow_tf32 = cudnn.allow_tf32 = tf32
        try:
            if strict:
                tr._update(*batch)
            else:  # the backward outside strict precision (only the forward inside)
                tr.opt.zero_grad(set_to_none=True)
                tr._loss(*batch, train=True)[0].backward()
        finally:
            mm.allow_tf32, cudnn.allow_tf32 = saved
        return torch.cat([p.grad.reshape(-1) for p in net.parameters()])

    strict = grads(False)
    scale = strict.abs().max()
    torch.testing.assert_close(grads(True), strict, rtol=1e-5, atol=1e-6 * scale)
    loose = grads(True, strict=False)
    assert (loose - strict).abs().max() > 1e-5 * scale


@pytest.mark.cuda
def test_lfmmi_gradients_on_card_equal_cpu(card):
    """The LF-MMI loss and emission gradient and the sMBR objective and
    its gradient on the card == on the CPU, 1e-4 relative."""
    rng = np.random.default_rng(9)
    P, Q, M, T = 6, 3, 20, 60
    kw = dict(classify=lambda p, q: (5 * p + q) % M,
              bigram_costs=rng.uniform(0.5, 2.0, size=(P, P)).astype(np.float32))
    e = rng.uniform(0.1, 4.0, size=(3, T, M)).astype(np.float32)
    n = np.array([60, 41, 17])
    ref = rng.integers(-1, M, size=(3, T))
    cls = rng.integers(0, M, size=(3, 9))
    graph = [np.full((3, 9), v, np.float32) for v in (0.7, 0.3, BIG)]
    graph[1][:, 0] = BIG
    init = np.full((3, 9), BIG, np.float32)
    init[:, 0] = 0.0
    final = np.full((3, 9), BIG, np.float32)
    final[:, -1] = 0.0
    out = {}
    for dev in ("cpu", card):
        den = lfmmi.build_phone_bigram_den(P, Q, device=dev, **kw)
        t = [torch.from_numpy(a).to(dev) for a in (e, n, *graph, init, final, cls, ref)]
        loss, grad = lfmmi.lfmmi_grad_emissions(t[0], den, *t[1:8])
        et = t[0].clone().requires_grad_(True)
        acc = lfmmi.expected_accuracy(et, den, t[1], t[8])
        acc.sum().backward()
        out[str(dev)] = [x.detach().cpu() for x in (loss, grad, acc, et.grad)]
    for got, want in zip(out[str(card)], out["cpu"]):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max())


def _rnn_text(s, seed, n=80):
    rng = np.random.default_rng(seed)
    words = [l.primary_orth for l in s.lexicon.lemmata if not l.special]
    return [list(rng.choice(words, size=6)) for _ in range(n)]


@pytest.mark.cuda
def test_fused_decode_on_card_equals_cpu(card):
    """RNN-LM fusion under the scaled-down production beam: the same RNN
    LM's tables on the card and on the CPU decode the card's emissions to
    the same words, scores within 1e-5, and the same record columns."""
    beam = BeamConfig(max_hyps=64, word_end_limit=16, root_hyps=4, branch_hyps=16,
                      root_arc_limit=12, root_select=48, deferred_emission=True, lm_scale=10.0)
    s = build_setup(num_words=80, num_phones=12, num_classes=150, densities=4, beam=beam,
                    device=card)
    rnn = RnnLm.train_from_text(_rnn_text(s, 2), embed_dim=16, hidden_dim=16, epochs=3,
                                device="cpu")
    fusion = build_rnn_fusion(rnn, s.lm.vocab, weight=0.5, device="cpu")
    on_card = TreeDecoder(s.tree, compile_ngram(s.lm), s.beam, rnn_fusion=fusion, device=card)
    on_cpu = TreeDecoder(s.tree, compile_ngram(s.lm), s.beam, rnn_fusion=fusion, device="cpu")
    x = torch.from_numpy((np.random.default_rng(8).normal(size=(3, 12000)) * 0.1)
                         .astype(np.float32)).to(card)
    feats, n = s.frontend(x, torch.tensor([12000, 9000, 5000], device=card))
    e = s.scorer(feats)
    ha, hb = on_card.decode_scores_device(e, n), on_cpu.decode_scores_device(e.cpu(), n.cpu())
    a, b = on_card.results_from_device(ha), on_cpu.results_from_device(hb)
    assert [r.words for r in a] == [r.words for r in b] and any(r.words for r in a)
    np.testing.assert_allclose([r.score for r in a], [r.score for r in b], rtol=1e-5)
    for col in ("lemma", "prev", "word", "lm"):
        assert torch.equal(getattr(ha.records, col).cpu(), getattr(hb.records, col))
    torch.testing.assert_close(ha.records.lmcost.cpu(), hb.records.lmcost, rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_rnn_lm_train_step_on_card_equals_cpu(card):
    """Adam steps of the RNN LM from one initial draw: the loss of every
    epoch (each a function of all earlier updates) on the card equals the
    CPU's within 1e-5 (float32 without TF32), and so do 99% of the
    parameters within 1e-4; the rest differ by at most Adam's step per
    epoch (its first steps move a parameter by ~lr x sign(g), and the sign
    of a near-zero gradient depends on the order of the float32 sums)."""
    s = build_setup(num_words=80, num_phones=12, num_classes=150, densities=4, device="cpu")
    text = _rnn_text(s, 3, n=200)
    lr, epochs = 1e-3, 5
    kw = dict(embed_dim=32, hidden_dim=64, epochs=epochs, seed=1, learning_rate=lr)
    a = RnnLm.train_from_text(text, device=card, **kw)
    b = RnnLm.train_from_text(text, device="cpu", **kw)
    np.testing.assert_allclose(a.train_losses, b.train_losses, rtol=1e-5)
    for (name, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        err = (p.cpu() - q).abs()
        assert float((err <= 1e-4 + 1e-4 * q.abs()).float().mean()) >= 0.99, name
        assert float(err.max()) <= 2 * lr * epochs, name


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [1.0, 0.92])
def test_mfcc_kernel_with_energy_and_warp_matches_plain(card, alpha):
    """The kernel's operands of a frontend with ``append_energy`` and a
    VTLN-warped mel (``with_energy``: one all-ones band and a unit DCT
    row and column): the kernel == its plain twin on them, the energy
    column included, and the column is the log of the unwarped frame
    energy."""
    cfg = FrontendConfig(append_energy=True)
    fe = FeatureFrontend(cfg, vtln_warp=piecewise_linear_warp(cfg.num_bins, alpha), device=card)
    rng = np.random.default_rng(17)
    sig = torch.from_numpy((rng.normal(size=(3, 16000)) * 0.1).astype(np.float32)).to(card)
    sig[1, :6000] *= 1e-3  # near-silent frames
    frames = frame_signal(preemphasize(sig, cfg.preemphasis), num_frames(16000, cfg), cfg)
    before = mfcc_frames.launches
    got = mfcc_frames(frames, fe.cosw, fe.sinw, fe.kmel, fe.kdct, cfg.log_floor, fe.basis)
    assert mfcc_frames.launches == before + 1 and got.shape[-1] == 17
    want = mfcc_frames_plain(frames, fe.cosw, fe.sinw, fe.kmel, fe.kdct, cfg.log_floor)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    energy = torch.log(torch.clamp(power_spectrum(frames, fe.params, cfg).sum(-1), min=1e-10))
    torch.testing.assert_close(got[..., 16], energy, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_frontend_options_on_card_equal_cpu(card):
    """All four options (energy, sliding CMVN, deltas, VTLN) on the card
    (the MFCC kernel, launch counted) and on the CPU: within 5e-2 (the
    sliding window's E[x^2] - mean^2 cancels ~5 digits on short rows,
    tests/test_torch_frontend.py)."""
    kw = dict(delta_order=2, vtln_warp=piecewise_linear_warp(257, 0.92))
    cfg = FrontendConfig(append_energy=True, normalize="sliding")
    x = torch.from_numpy((np.random.default_rng(4).normal(size=(3, 12000)) * 0.1)
                         .astype(np.float32))
    lengths = torch.tensor([12000, 9000, 5000])
    before = mfcc_frames.launches
    f_card, n_card = FeatureFrontend(cfg, device=card, **kw)(x.to(card), lengths.to(card))
    assert mfcc_frames.launches == before + 1
    f_cpu, n_cpu = FeatureFrontend(cfg, device="cpu", **kw)(x, lengths)
    assert f_card.shape[-1] == 51 and torch.equal(n_card.cpu(), n_cpu)
    torch.testing.assert_close(f_card.cpu(), f_cpu, rtol=2e-4, atol=5e-2)


@pytest.mark.cuda
def test_gammatone_on_card_equals_cpu_without_tf32(card):
    """The gammatone frontend with cuDNN's TF32 allowed globally: its
    convolutions still run in float32 (strict precision inside), so the
    card's features equal the CPU's within 1e-4 relative."""
    cfg = GammatoneConfig(num_outputs=20)
    x = torch.from_numpy((np.random.default_rng(6).normal(size=(2, 48000)) * 0.1)
                         .astype(np.float32))
    lengths = torch.tensor([48000, 31234])
    torch.backends.cudnn.allow_tf32 = True
    try:
        f_card, n_card = GammatoneFrontend(cfg, device=card)(x.to(card), lengths.to(card))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    f_cpu, n_cpu = GammatoneFrontend(cfg, device="cpu")(x, lengths)
    assert torch.equal(n_card.cpu(), n_cpu)
    torch.testing.assert_close(f_card.cpu(), f_cpu, rtol=1e-4, atol=1e-5)


def _alternating_wfst(lm, lemmas):
    """A (B C)* D over the first four lemmas, classes 0-3."""
    fsa = Automaton()
    s0, s1, s2, s3 = (fsa.add_state() for _ in range(4))
    fsa.initial = s0
    for a, b, w, cost in ((s0, s1, 0, 0.0), (s1, s2, 1, 0.1), (s2, s1, 2, 0.2), (s1, s3, 3, 0.0)):
        fsa.add_arc(a, b, w + 1, w + 1, cost)
    fsa.set_final(s3)
    words = [l.primary_orth for l in lemmas]
    return compile_wfst(fsa, 4, lemmas, 0.3, {i: lm.vocab[w] for i, w in enumerate(words)})


@pytest.mark.cuda
def test_wfst_decode_on_card_equals_cpu(card):
    """A grammar network under its re-entry lookahead: the card's decode
    == the CPU's (words, scores within 1e-5, every record column)."""
    from rasr_tpu_torch.models.lm.arpa import NgramLm

    class Lemma:
        special = None

        def __init__(self, orth):
            self.primary_orth = orth

        def eval_tokens(self):
            return [self.primary_orth]

    lm = NgramLm.train_from_text([["A"] + ["B", "C"] * k + ["D"] for k in (0, 1, 1, 2, 3)],
                                 order=2)
    tree = _alternating_wfst(lm, [Lemma(w) for w in "ABCD"])
    la = build_bigram_lookahead(tree, lm, num_classes=6)
    assert la.reentry
    beam = BeamConfig(max_hyps=8, word_end_limit=4, root_hyps=3, lm_scale=0.8)
    on_card, on_cpu = (TreeDecoder(tree, compile_ngram(lm), beam, bigram_la=la, device=d)
                       for d in (card, "cpu"))
    e = torch.from_numpy(np.random.default_rng(9).uniform(0, 4, size=(3, 20, 4))
                         .astype(np.float32))
    n = torch.tensor([20, 15, 11])
    ha, hb = on_card.decode_scores_device(e.to(card), n.to(card)), on_cpu.decode_scores_device(e, n)
    a, b = on_card.results_from_device(ha), on_cpu.results_from_device(hb)
    assert [r.words for r in a] == [r.words for r in b] and all(r.words for r in a)
    np.testing.assert_allclose([r.score for r in a], [r.score for r in b], rtol=1e-5)
    for col in ("lemma", "prev", "word", "lm"):
        assert torch.equal(getattr(ha.records, col).cpu(), getattr(hb.records, col))


def _per_slot_lm(seed=0, words=300, order=3):
    """A random LM through ``compile_packed`` (per-slot probed tables)."""
    from rasr_tpu_torch.models.lm.arpa import NgramLm
    from rasr_tpu_torch.models.lm.packed import PackedNgramLm, compile_packed

    rng = np.random.default_rng(seed)
    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2}
    for i in range(words):
        vocab[f"w{i}"] = len(vocab)
    ids = list(vocab.values())
    ngrams = {(w,): (float(rng.uniform(1, 9)), float(rng.uniform(0.1, 2))) for w in ids}
    for k in range(2, order + 1):
        prev = [g for g in ngrams if len(g) == k - 1]
        for _ in range(6 * words):
            g = prev[int(rng.integers(len(prev)))] + (int(rng.choice(ids)),)
            ngrams[g] = (float(rng.uniform(1, 8)), float(rng.uniform(0.1, 1.5)) if k < order
                         else 0.0)
    return compile_packed(PackedNgramLm.from_ngram_lm(NgramLm(order, vocab, ngrams)))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["replicated", "per-probe"])
def test_per_slot_lookup_on_card_equals_cpu(card, route, monkeypatch):
    """Per-slot ``lookup_prepared`` on the card == on the CPU, on both
    routes (the window threshold at 0 forces one gather per probe)."""
    from rasr_tpu_torch.models.lm import ngram

    tables = _per_slot_lm()
    assert tables.bucket_bits == 0
    if route == "per-probe":
        monkeypatch.setattr(ngram, "REP_WINDOW_BYTES", 0)
    rng = np.random.default_rng(1)
    states = torch.from_numpy(rng.integers(0, tables.num_states, 4096))
    words = torch.from_numpy(rng.integers(0, 310, 4096))
    got = ngram.lookup_prepared(tables.to(card), ngram.prepare_lookup(tables.to(card)),
                                states.to(card), words.to(card))
    want = ngram.lookup_prepared(tables, ngram.prepare_lookup(tables), states, words)
    assert ngram.prepare_lookup(tables).probes == (tables.max_probe if route == "per-probe" else 0)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_packed_decode_on_card_equals_bucketed(card, tmp_path):
    """The decoder over packed per-slot tables (the native parse of the
    LM's ARPA file) on the card gives the words and scores of the decoder
    over the bucketed tables of the same file, bit for bit."""
    from rasr_tpu_torch.models.lm.arpa import NgramLm
    from rasr_tpu_torch.models.lm.packed import PackedNgramLm, compile_packed
    from rasr_tpu_torch.utils import native

    assert native.load_native() is not None, native.build_error
    beam = BeamConfig(max_hyps=64, word_end_limit=16, root_hyps=8, branch_hyps=16, lm_scale=10.0)
    s = build_setup(num_words=200, num_classes=200, densities=2, beam=beam, device=card)
    arpa = str(tmp_path / "lm.arpa")
    s.lm.write_arpa(arpa)
    x = torch.from_numpy((np.random.default_rng(2).normal(size=(4, 32000)) * 0.1)
                         .astype(np.float32)).to(card)
    feats, n = s.frontend(x, torch.full((4,), 32000, device=card))
    e = s.scorer(feats)
    res = [TreeDecoder(s.tree, t, s.beam, device=card).decode_scores(e, n)
           for t in (compile_packed(PackedNgramLm.from_arpa(arpa)),
                     compile_ngram(NgramLm.read_arpa(arpa)))]
    assert [(r.words, r.score) for r in res[0]] == [(r.words, r.score) for r in res[1]]
    assert all(r.words for r in res[0])


@pytest.mark.cuda
def test_tool_runs_on_the_card(card, tmp_path):
    """A tool started without ``device`` computes on the card: features
    through the MFCC kernel equal the CPU run's within the kernel's
    tolerance, and the run logs its kernel launches."""
    import json
    import os

    from rasr_tpu_torch.corpus.audio import write_wav
    from rasr_tpu_torch.utils.archive import FileArchive, unpack_ndarray

    rng = np.random.default_rng(3)
    xml = ['<corpus name="c">']
    for i in range(3):
        write_wav(str(tmp_path / f"r{i}.wav"), (rng.normal(size=16000 + 4000 * i) * 0.1)
                  .astype(np.float32))
        xml.append(f'<recording name="r{i}" audio="r{i}.wav"><segment name="s"><orth>x</orth>'
                   "</segment></recording>")
    (tmp_path / "c.corpus").write_text("".join(xml) + "</corpus>")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for label, extra in (("card", []), ("cpu", ["--*.device=cpu"])):
        proc = subprocess.run(
            [sys.executable, "-m", "rasr_tpu_torch.tools.feature_extraction",
             "--feature-extraction.corpus-file=c.corpus", f"--feature-extraction.cache={label}",
             f"--feature-extraction.log-file={label}.log", *extra],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    records = [json.loads(line) for line in (tmp_path / "card.log").read_text().splitlines()]
    assert records[0]["card"] and records[-1]["mfcc_frames"] >= 1
    with FileArchive(str(tmp_path / "card"), "r") as a, FileArchive(str(tmp_path / "cpu"), "r") as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a.keys():
            np.testing.assert_allclose(unpack_ndarray(a.read(k)), unpack_ndarray(b.read(k)),
                                       rtol=1e-3, atol=1e-3)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card: exit non-zero and print no result. Alone in a directory
    (no port beside it): the same, card or not."""
    runs = [tmp_path]
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    if not torch.cuda.is_available():
        runs.append(REPO)
    for cwd in runs:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_cuda_device_and_build_errors():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cuda_device()
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "gmm_scores")
    _build.check(0, "gmm_scores")
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path == _build.library_path()
    assert {s.name for s in _build._sources()} == {
        "gmm_fused.cu", "mfcc_fused.cu", "row_gather.cu", "wordend_fused.cu"}


@pytest.mark.parametrize("edited", ["tf32x3.cuh", "gmm_fused.cu"])
def test_library_path_follows_sources_and_headers(tmp_path, monkeypatch, edited):
    """An edit to a shared header, as to a source, names another library,
    so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    assert before == _build.library_path()
    with open(csrc / edited, "a") as fh:
        fh.write("\n// edited\n")
    assert _build.library_path() != before


def test_entry_points_match_the_c_sources():
    """Every ctypes entry point is an ``extern "C"`` function of csrc/ with
    as many parameters as its argtypes (a missing argtype would pass a
    pointer as a 32-bit int)."""
    found = {}
    for src in _build._sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len(params.split(","))
    assert found == {name: len(types) for name, types in _build.ENTRY_POINTS.items()}
