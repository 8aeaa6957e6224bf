"""PyTorch port vs JAX: the LSTM language model (``models/lm/rnn.py``).

The reference's flax parameters carried across (``convert.rnn_lm_from_flax``)
give the same logits (float32, 1e-5) and the same history scores; the
history cache holds what a fresh run over the whole history computes and
evicts in the reference's order; unknown words cost 99 and keep the
history; save / load scores bit-identically; ``train_from_text`` from the
reference's initial parameters follows optax's Adam loss for loss (1e-4
per epoch) and ends at its parameters; the port's own initializer draws
flax's distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rasr_tpu.models.lm.rnn import LstmLmModule
from rasr_tpu.models.lm.rnn import RnnLm as JaxRnnLm
from rasr_tpu_torch import convert
from rasr_tpu_torch.models.lm.rnn import OOV_COST, LstmLm, RnnLm, init_lstm_lm

WORDS = ["AB", "BA", "AA", "CC", "DA"]


def _sentences(seed=7, n=40):
    rng = np.random.default_rng(seed)
    return [[WORDS[i] for i in rng.integers(0, len(WORDS), size=rng.integers(1, 5))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def pair():
    jlm = JaxRnnLm.train_from_text(_sentences(), embed_dim=8, hidden_dim=12, epochs=15)
    return jlm, convert.rnn_lm_from_flax(jlm, device="cpu")


def _histories(lm, seed=0, n=12):
    rng = np.random.default_rng(seed)
    ids = sorted(lm.vocab.values())
    return [tuple(int(w) for w in rng.choice(ids, size=rng.integers(0, 5))) for _ in range(n)]


def test_logits_match_flax(pair):
    jlm, lm = pair
    toks = np.random.default_rng(1).integers(0, len(lm.vocab), size=(3, 6))
    want, (wc, wh) = jlm.module.apply({"params": jlm.params}, jnp.asarray(toks))
    with torch.no_grad():
        got, (c, h) = lm.model(torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=1e-5)


def test_history_scores_match_jax(pair):
    jlm, lm = pair
    for hist in _histories(lm):
        for w in sorted(lm.vocab.values()):
            np.testing.assert_allclose(lm.score(hist, w), jlm.score(hist, w), atol=1e-5)
    for sent in _sentences(seed=3, n=5):
        np.testing.assert_allclose(lm.sequence_score(sent), jlm.sequence_score(sent), rtol=1e-5)


def test_cache_holds_consistent_states_and_evicts_first_in(pair):
    """Each cached entry == a fresh run of the model over <s> + history;
    a small cache keeps the reference's keys in the reference's order."""
    jlm, lm = pair
    small = RnnLm(lm.model, lm.vocab, cache_size=5, device="cpu")
    jsmall = JaxRnnLm(jlm.module, jlm.params, jlm.vocab, cache_size=5)
    for hist in _histories(lm, seed=4):
        small.score(hist, 1)
        jsmall.score(hist, 1)
        assert list(small._cache) == list(jsmall._cache)
    for hist, (logp, (c, h)) in small._cache.items():
        toks = torch.tensor([[lm.vocab["<s>"], *hist]])
        with torch.no_grad():
            logits, (fc, fh) = lm.model(toks)
        np.testing.assert_allclose(logp, torch.log_softmax(logits[0, -1], -1).numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(c.numpy(), fc.numpy(), atol=1e-6)
        np.testing.assert_allclose(h.numpy(), fh.numpy(), atol=1e-6)


def test_unknown_words(pair):
    """An unknown token has id -1, costs 99 and leaves the history as it
    is, in both packages."""
    jlm, lm = pair
    assert lm.word_id("ZZ") == jlm.word_id("ZZ") == -1
    h = (lm.vocab["AB"],)
    assert lm.score(h, -1) == jlm.score(h, -1) == OOV_COST
    assert lm.extended_history(h, -1) == jlm.extended_history(h, -1) == h
    sent = ["AB", "ZZ", "BA"]
    np.testing.assert_allclose(lm.sequence_score(sent), jlm.sequence_score(sent), rtol=1e-5)


def test_save_load_scores_bit_identically(pair, tmp_path):
    _, lm = pair
    path = str(tmp_path / "rnnlm")
    lm.save(path)
    back = RnnLm.load(path, device="cpu")
    assert back.vocab == lm.vocab
    assert (back.model.embed_dim, back.model.hidden_dim) == (8, 12)
    for hist in _histories(lm, seed=5):
        for w in sorted(lm.vocab.values()):
            assert back.score(hist, w) == lm.score(hist, w)


def _jax_loss(jlm, sents):
    """The reference's training loss of ``jlm``'s parameters on ``sents``
    (its tokens, padding and mask)."""
    vocab = jlm.vocab
    seqs = [[0] + [vocab[t] for t in s] + [1] for s in sents]
    T = max(len(s) for s in seqs)
    tokens = np.full((len(seqs), T), 1, np.int32)
    mask = np.zeros((len(seqs), T), np.float32)
    for i, s in enumerate(seqs):
        tokens[i, : len(s)] = s
        mask[i, 1: len(s)] = 1.0
    logits, _ = jlm.module.apply({"params": jlm.params}, jnp.asarray(tokens[:, :-1]))
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(tokens[:, 1:]))
    m = mask[:, 1:]
    return float((ce * m).sum() / max(m.sum(), 1.0))


def test_training_follows_optax(pair):
    """From the reference's initial draw (its train_from_text at 0 epochs),
    the port's full-batch Adam steps give the reference's loss at every
    epoch and its parameters after 5."""
    sents = _sentences(seed=11, n=30)
    kw = dict(embed_dim=8, hidden_dim=12, learning_rate=0.05, seed=2)
    jax_runs = [JaxRnnLm.train_from_text(sents, epochs=e, **kw) for e in range(6)]
    init = convert.lstm_lm_params_from_flax(jax_runs[0].params)
    lm = RnnLm.train_from_text(sents, epochs=5, device="cpu", init=init, **kw)
    assert lm.vocab == jax_runs[0].vocab
    want = [_jax_loss(j, sents) for j in jax_runs[:5]]
    np.testing.assert_allclose(lm.train_losses, want, rtol=1e-4, atol=1e-4)
    assert lm.train_losses[-1] < lm.train_losses[0]
    final = convert.lstm_lm_params_from_flax(jax_runs[5].params)
    for name, p in lm.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), atol=1e-4, err_msg=name)


def test_own_init_draws_flax_distributions():
    """The port's initializer (a torch.Generator): the embedding's and
    kernels' scales as flax's draw them (within 5%), orthogonal recurrent
    gate blocks, zero biases; the same seed draws the same parameters."""
    V, E, H = 3000, 64, 128
    flax_params = LstmLmModule(V, E, H).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 1), jnp.int32))["params"]
    want = convert.lstm_lm_params_from_flax(flax_params)
    model = init_lstm_lm(LstmLm(V, E, H), torch.Generator().manual_seed(0))
    got = model.state_dict()
    for name in ("embed.weight", "wx", "proj.weight"):
        np.testing.assert_allclose(got[name].std().item(), want[name].std().item(), rtol=0.05,
                                   err_msg=name)
        assert abs(got[name].mean().item()) < 0.01
        # truncated at two standard deviations where flax truncates
        ratio = (got[name].abs().max() / got[name].std()).item()
        want_ratio = (want[name].abs().max() / want[name].std()).item()
        assert (ratio < 2.5) == (want_ratio < 2.5), name
    for gate in range(4):
        block = got["wh"][:, gate * H: (gate + 1) * H].double()
        np.testing.assert_allclose((block.T @ block).numpy(), np.eye(H), atol=1e-5)
    for name in ("b", "proj.bias"):
        assert not got[name].any() and not want[name].any()
    again = init_lstm_lm(LstmLm(V, E, H), torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)
