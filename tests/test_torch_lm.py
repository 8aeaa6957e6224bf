"""PyTorch port vs JAX: the hash-table n-gram LM.

The compiled tables must equal the reference's bit for bit, the torch
hash must equal the host ``_hash``, and lookups must equal the JAX
lookups exactly (same float additions in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rasr_tpu.models.lm import ngram_tpu as jlm
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu_torch import convert
from rasr_tpu_torch.models.lm import ngram as tlm

TEXTS = [
    ["AB", "BA"], ["AB", "AA"], ["BA", "BAB"], ["BAB", "AB"],
    ["AA", "AB", "BA", "BAB"], ["BA", "BA", "AA", "AB", "BAB"],
]
FIELDS = ("key_state", "key_word", "val_cost", "val_next", "backoff_cost", "backoff_state")
SCALARS = ("order", "max_probe", "start_state", "end_word", "unk_word", "num_states",
           "bucket_bits")


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (a.view(np.uint8) == b.view(np.uint8)).all()


@pytest.mark.parametrize("order", [2, 4])
def test_compiled_tables_bit_identical(order):
    lm = NgramLm.train_from_text(TEXTS, order=order)
    want = jlm.compile_ngram(lm)
    got = tlm.compile_ngram(lm)
    carried = convert.ngram_tables_from_jax(want)
    for t in (got, carried):
        for f in FIELDS:
            assert _bits_equal(getattr(t, f).numpy(), getattr(want, f)), f
        for f in SCALARS:
            assert getattr(t, f) == getattr(want, f), f
    assert tlm.state_contexts(lm) == jlm.state_contexts(lm)


def test_hash_matches_host_hash(rng):
    s = rng.integers(0, 2**31 - 1, 20000)
    w = rng.integers(0, 2**31 - 1, 20000)
    for mask in (0, 1, 2**10 - 1, 2**20 - 1, 2**31 - 1):
        want = jlm._hash(s, w, mask)
        got = tlm.hash_torch(torch.from_numpy(s), torch.from_numpy(w), mask).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tlm._hash(s, w, mask), want)


@pytest.mark.parametrize("order", [2, 4])
def test_lookup_matches_jax(rng, order):
    lm = NgramLm.train_from_text(TEXTS, order=order)
    jt = jlm.compile_ngram(lm)
    tt = tlm.compile_ngram(lm)
    n = 600
    states = rng.integers(0, jt.num_states, n).astype(np.int32)
    # word ids past the vocabulary hit the no-unigram default row
    words = rng.integers(0, len(lm.vocab) + 3, n).astype(np.int32)
    want_cost, want_next = jlm.lookup(jt, jnp.asarray(states), jnp.asarray(words))
    got_cost, got_next = tlm.lookup(tt, torch.from_numpy(states), torch.from_numpy(words))
    assert _bits_equal(got_cost.numpy(), want_cost)
    np.testing.assert_array_equal(got_next.numpy(), np.asarray(want_next))
    # 2-D index shapes go through unchanged
    c2, n2 = tlm.lookup(tt, torch.from_numpy(states).reshape(20, 30),
                        torch.from_numpy(words).reshape(20, 30))
    np.testing.assert_array_equal(c2.reshape(-1).numpy(), got_cost.numpy())


def test_unigram_default_without_unk():
    """No <unk> in the LM: unknown words cost 99 and go to state 0."""
    lm = NgramLm(2, {"<s>": 0, "</s>": 1, "a": 2},
                 {(0,): (1.0, 0.5), (1,): (2.0, 0.0), (2,): (3.0, 0.25), (0, 2): (0.5, 0.0)})
    tt = tlm.compile_ngram(lm)
    prep = tlm.prepare_lookup(tt)
    assert prep.uni_cost[-1].item() == 99.0 and prep.uni_next[-1].item() == 0
    cost, nxt = tlm.lookup_prepared(tt, prep, torch.tensor([0, 0, 2]), torch.tensor([2, 7, 2]))
    want_cost, want_next = jlm.lookup(
        jlm.compile_ngram(lm), jnp.asarray([0, 0, 2]), jnp.asarray([2, 7, 2])
    )
    np.testing.assert_array_equal(cost.numpy(), np.asarray(want_cost))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(want_next))
