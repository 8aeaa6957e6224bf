"""PyTorch port vs JAX: the NN acoustic models and the hybrid scorer.

Each network of ``rasr_tpu/models/nn.py`` is initialised by flax, its
parameters carried into the port's module by ``convert.nn_params_from_flax``,
and both run on the same seeded numpy inputs on the CPU. Float32 networks
agree to float32 rounding (tolerances below); bf16 networks round where
flax rounds (per-op bf16 results, float32 LayerNorms and softmax), so most
of their outputs are bit-equal and the rest within a few bf16 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rasr_tpu.models import nn as jnn
from rasr_tpu.models.scorer import create_scorer as jax_create_scorer
from rasr_tpu_torch import convert
from rasr_tpu_torch.models import nn as tnn
from rasr_tpu_torch.models.scorer import create_scorer

# float32: the same ops, sums in other orders (~1e-6 seen on these sizes)
F32 = dict(rtol=1e-4, atol=1e-4)
# bf16: logits within |4|, where a bf16 ulp is 2^-6 (0.0156); at most two
# ulps apart, and at least 90% bit-equal
BF16_ATOL, BF16_EQUAL = 0.032, 0.9

B, T, D, M = 3, 17, 6, 7
LENGTHS = np.array([17, 11, 5])


def _inputs(seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32)


def _port(jax_model, port_model, x, seed=0, **init_kw):
    """flax init on ``x``, the port's module loaded with those parameters."""
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x), **init_kw)["params"]
    port_model.load_state_dict(convert.nn_params_from_flax(port_model, params))
    return params


def _valid(lengths):
    return np.arange(T)[None, :] < lengths[:, None]


@pytest.mark.parametrize("activation", ["relu", "gelu", "sigmoid", "tanh", "identity"])
def test_feedforward_matches_jax(activation):
    x = _inputs(1)
    jm = jnn.FeedForwardNet(num_classes=M, hidden=(16, 8), activation=activation)
    tm = tnn.FeedForwardNet(M, D, hidden=(16, 8), activation=activation, device="cpu")
    params = _port(jm, tm, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), want, **F32)


def test_feedforward_bf16_matches_jax():
    x = _inputs(2)
    kw = dict(hidden=(32, 16), activation="gelu", compute_dtype="bfloat16")
    jm = jnn.FeedForwardNet(num_classes=M, **kw)
    tm = tnn.FeedForwardNet(M, D, **kw, device="cpu")
    params = _port(jm, tm, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    assert np.mean(got == want) >= BF16_EQUAL


def test_conv_frontend_matches_jax():
    x = _inputs(3)
    jm = jnn.ConvFrontendNet(num_classes=M, channels=(8, 5), hidden=(16,))
    tm = tnn.ConvFrontendNet(M, D, channels=(8, 5), hidden=(16,), device="cpu")
    params = _port(jm, tm, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), want, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blstm_matches_jax_on_ragged_lengths(dtype):
    """Two layers; with ragged lengths the backward direction starts at
    each utterance's own last frame. Compared on the valid frames. Under
    bf16 the port's LSTM keeps its cell state in bf16 where flax keeps
    float32: held to 0.02 (the logits stay within |1|)."""
    x = _inputs(4)
    jm = jnn.BlstmEncoderNet(num_classes=M, hidden=(8, 5), compute_dtype=dtype)
    tm = tnn.BlstmEncoderNet(M, D, hidden=(8, 5), compute_dtype=dtype, device="cpu")
    params = _port(jm, tm, x)
    tol = F32 if dtype == "float32" else dict(rtol=0, atol=0.02)
    valid = _valid(LENGTHS)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), lengths=jnp.asarray(LENGTHS)))
    got = tm(torch.from_numpy(x), lengths=torch.from_numpy(LENGTHS)).detach().numpy()
    np.testing.assert_allclose(got[valid], want[valid], **tol)
    # the valid prefix alone gives the same frames
    alone = tm(torch.from_numpy(x[1:2, :LENGTHS[1]])).detach().numpy()
    np.testing.assert_allclose(got[1, :LENGTHS[1]], alone[0], **tol)
    want_full = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), want_full, **tol)


def _conformers(dtype, **kw):
    kw = dict(d_model=32, num_blocks=2, num_heads=4, conv_kernel=5, **kw)
    return (jnn.ConformerEncoderNet(num_classes=M, compute_dtype=dtype, **kw),
            tnn.ConformerEncoderNet(M, D, compute_dtype=dtype, device="cpu", **kw))


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conformer_matches_jax(dtype, with_lengths):
    """d=32, 2 blocks, 4 heads, conv kernel 5, B=3 with ragged lengths
    (compared on the valid frames) or without lengths (every frame)."""
    x = _inputs(5)
    jm, tm = _conformers(dtype)
    params = _port(jm, tm, x)
    kw = dict(lengths=LENGTHS) if with_lengths else {}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = tm(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kw.items()})
    got = got.detach().numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    valid = _valid(LENGTHS) if with_lengths else np.ones((B, T), bool)
    if dtype == "float32":
        np.testing.assert_allclose(got[valid], want[valid], **F32)
    else:
        np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=BF16_ATOL)
        assert np.mean(got[valid] == want[valid]) >= BF16_EQUAL
        # and it is a bf16 result: the float32 network lands elsewhere
        tm32 = _conformers("float32")[1]
        tm32.load_state_dict(tm.state_dict())
        f32 = tm32(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert np.abs(f32.detach().numpy() - got)[valid].max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conformer_padding_invariance(dtype):
    """tests/test_nn.py:224 on the port: an utterance padded with garbage,
    its length given, scores its valid prefix as it alone would; the
    padded rows stay finite (a fully masked attention row is uniform, not
    NaN, and no NaN reaches the conv modules)."""
    x1 = _inputs(6)[:1, :9]
    _, tm = _conformers(dtype)
    tnn.init_params(tm, 3)
    x2 = np.concatenate([x1, 7.7 * np.ones((1, T - 9, D), np.float32)], axis=1)
    out1 = tm(torch.from_numpy(x1)).detach().numpy()
    out2 = tm(torch.from_numpy(x2), lengths=torch.tensor([9])).detach().numpy()
    assert np.isfinite(out2).all()
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else dict(rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(out2[:, :9], out1, **tol)


def test_init_params_follows_flax_distributions():
    """lecun_normal kernels (variance 1 / fan-in, truncated at 2 sigma),
    zero biases, unit LayerNorm scales; the same seed draws the same."""
    tm = tnn.init_params(_conformers("float32", ff_mult=4)[1], 7)
    w = tm.block[0].ff1_in.weight.detach()  # [128, 32]: fan-in 32
    assert abs(float(w.std()) - (1 / 32) ** 0.5) < 0.1 * (1 / 32) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 32) ** 0.5 / 0.87962566103423978 + 1e-6
    dw = tm.block[1].conv_dw.weight.detach()  # [32, 1, 5]: fan-in 5
    assert abs(float(dw.std()) - 5 ** -0.5) < 0.15 * 5 ** -0.5
    assert float(tm.output.bias.detach().abs().max()) == 0.0
    assert torch.equal(tm.block[0].final_ln.weight, torch.ones(32))
    again = tnn.init_params(_conformers("float32")[1], 7)
    for a, b in zip(tm.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    blstm = tnn.init_params(tnn.BlstmEncoderNet(M, D, hidden=(8,), device="cpu"), 1)
    hh = blstm.layers[0].weight_hh_l0_reverse[8:16].detach()  # one gate's recurrent kernel
    torch.testing.assert_close(hh @ hh.T, torch.eye(8), rtol=0, atol=1e-5)


def test_priors_from_counts_and_io(tmp_path):
    p = tnn.StatePriors.from_counts(np.array([10, 30, 60]), smoothing=0.0)
    np.testing.assert_allclose(np.exp(p.log_priors), [0.1, 0.3, 0.6], rtol=1e-6)
    counts = np.array([1, 2, 3])
    p = tnn.StatePriors.from_counts(counts)
    np.testing.assert_array_equal(p.log_priors, jnn.StatePriors.from_counts(counts).log_priors)
    p.save(str(tmp_path / "priors"))
    np.testing.assert_array_equal(tnn.StatePriors.load(str(tmp_path / "priors")).log_priors,
                                  p.log_priors)
    # the port reads what the reference writes
    jnn.StatePriors.from_counts(counts * 2).save(str(tmp_path / "ref.npy"))
    np.testing.assert_array_equal(tnn.StatePriors.load(str(tmp_path / "ref.npy")).log_priors,
                                  jnn.StatePriors.from_counts(counts * 2).log_priors)


def test_hybrid_scorer_math_matches_jax(rng):
    """tests/test_nn.py:138: scale * (-(log_softmax - prior_scale * log prior))."""
    jm = jnn.FeedForwardNet(num_classes=4, hidden=(16,))
    tm = tnn.FeedForwardNet(4, 8, hidden=(16,), device="cpu")
    feats = rng.normal(size=(1, 3, 8)).astype(np.float32)
    params = _port(jm, tm, feats)
    priors = np.array([1, 2, 3, 4])
    want = jnn.NnHybridScorer(jm, params, jnn.StatePriors.from_counts(priors), scale=2.0,
                              prior_scale=0.5)(feats)
    scorer = tnn.NnHybridScorer(tm, None, tnn.StatePriors.from_counts(priors), scale=2.0,
                                prior_scale=0.5, device="cpu")
    np.testing.assert_allclose(scorer(torch.from_numpy(feats)).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert scorer.num_classes == 4


def test_hybrid_scorer_threads_lengths_and_registry(rng):
    """tests/test_nn.py:153 and :275: both registry names build the hybrid
    scorer; a conformer gets the lengths, a frame-wise network ignores
    them; the scorer loads a state_dict handed to it."""
    x = _inputs(8)
    jm, tm = _conformers("float32")
    params = _port(jm, tm, x)
    priors = jnn.StatePriors(np.log(np.full(M, 1.0 / M, np.float32)))
    want = jnn.NnHybridScorer(jm, params, priors)(x, lengths=LENGTHS)
    fresh = _conformers("float32")[1]
    for name in ("nn-hybrid", "nn-precomputed-hybrid"):
        scorer = create_scorer(name, fresh, convert.nn_params_from_flax(fresh, params),
                               tnn.StatePriors(priors.log_priors), device="cpu")
        assert isinstance(scorer, tnn.NnHybridScorer)
        assert type(jax_create_scorer(name, jm, params, priors)).__name__ == "NnHybridScorer"
        got = scorer(torch.from_numpy(x), lengths=torch.from_numpy(LENGTHS)).numpy()
        valid = _valid(LENGTHS)
        np.testing.assert_allclose(got[valid], np.asarray(want)[valid], **F32)
    ff = tnn.NnHybridScorer(tnn.FeedForwardNet(M, D, hidden=(4,), device="cpu"), None,
                            tnn.StatePriors(priors.log_priors), device="cpu")
    full = ff(torch.from_numpy(x))
    torch.testing.assert_close(ff(torch.from_numpy(x), lengths=torch.from_numpy(LENGTHS)), full)


def test_strict_precision_restores_the_settings():
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32)
    cudnn.allow_tf32 = True
    try:
        with tnn.strict_precision():
            assert (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
                    cudnn.allow_tf32) == (False, False, False)
        assert cudnn.allow_tf32 is True
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32 = before


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        tnn.FeedForwardNet(M, D, compute_dtype="float16", device="cpu")
