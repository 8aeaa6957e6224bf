"""PyTorch port vs JAX: the word-end and row-gather kernels' plain versions.

``examples/pallas_wordend_microbench.py`` and
``examples/pallas_gather_microbench.py`` hold two TPU kernels and their
XLA twins. The port's wrappers (``rasr_tpu_torch.ops.kernels.wordend``
and ``.row_gather``) run their plain versions on CPU tensors; these must
be bit-equal to the XLA twins and to the Pallas kernels run in interpret
mode (the JAX examples are imported as they are; only the interpret
switch is set from the test). The port's microbench inputs must be the
JAX examples' own draws.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rasr_tpu_torch.examples import gather_microbench, kernel_bench, wordend_microbench
from rasr_tpu_torch.ops.kernels import row_gather as rg
from rasr_tpu_torch.ops.kernels import wordend as we

REPO = Path(__file__).resolve().parent.parent


def _example(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jwe():
    return _example("pallas_wordend_microbench")


@pytest.fixture(scope="module")
def jgather():
    return _example("pallas_gather_microbench")


def _port_wordend(inputs, c_sp):
    w_state, w_score, combo, emis = (torch.from_numpy(x) for x in inputs)
    before = we.wordend_block.launches
    out = we.wordend_block(w_state, w_score, combo, emis, c_sp)
    assert we.wordend_block.launches == before  # CPU tensors: the plain version
    return [o.numpy() for o in out]


def _assert_bit_equal(got, want):
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        # f32 outputs compared as bits: equal values AND equal encodings
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_microbench_inputs_are_the_jax_examples_draws(jwe, jgather, monkeypatch):
    """Run each JAX example's main() with its timing stubbed out and
    capture the arrays it would time: the port's make_inputs must draw
    the same ones from default_rng(0), in the same order."""
    seen = []

    def record(fn, *args, **_):
        seen.append([np.asarray(a) for a in args])
        return 1.0 if getattr(fn, "__name__", "") == "xla_gather" else (1.0, None)

    def no_pallas(*_, **__):
        raise RuntimeError("not built in this test")

    for mod, maker in ((jwe, "make_kernel"), (jgather, "make_pallas_gather")):
        monkeypatch.setattr(mod, "bench", record)
        monkeypatch.setattr(mod, maker, no_pallas)
        monkeypatch.setattr(mod.jax, "jit", lambda fn: fn)
    jwe.main()
    ws, sc, combo20, em = seen[0]
    w_state, w_score, combo, emis = wordend_microbench.make_inputs(**wordend_microbench.SHAPE)
    np.testing.assert_array_equal(w_state, ws)
    np.testing.assert_array_equal(w_score.view(np.int32), sc.view(np.int32))
    np.testing.assert_array_equal(combo[:, :20], combo20)
    assert combo.shape == (wordend_microbench.SHAPE["S1"], 24) and not combo[:, 20:].any()
    np.testing.assert_array_equal(emis.view(np.int32), em.view(np.int32))
    jgather.main()
    table, idx = gather_microbench.make_inputs(**gather_microbench.SHAPE)
    np.testing.assert_array_equal(table, seen[1][0])
    np.testing.assert_array_equal(idx, seen[1][1])


@pytest.mark.parametrize("shape", [
    dict(B=2, KW=16, S1=50, C=40, C_sp=12),
    dict(B=3, KW=13, S1=37, C=21, C_sp=5),  # ragged: no multiple of 8 or 4
    wordend_microbench.SHAPE,  # the microbench's own shape
])
def test_wordend_plain_equals_xla_block(jwe, shape):
    inputs = wordend_microbench.make_inputs(**shape)
    w_state, w_score, combo, emis = inputs
    combo[w_state[0, 0], 0] = we.WORD_NONE  # the example never draws it
    want = jax.jit(functools.partial(jwe.xla_block, B=shape["B"], KW=shape["KW"],
                                     C_sp=shape["C_sp"]))(
        jnp.asarray(w_state), jnp.asarray(w_score), jnp.asarray(combo), jnp.asarray(emis))
    got = _port_wordend(inputs, shape["C_sp"])
    _assert_bit_equal(got, want)
    # both branches of each select are exercised
    assert (got[1] >= 1e30).any() and (got[1] < 1e30).any()
    assert got[0][0, 0] == np.float32(1e30) and (got[0] < 1e30).any()


def test_wordend_plain_equals_pallas_kernel_interpreted(jwe, monkeypatch):
    monkeypatch.setenv("PALLAS_INTERPRET", "1")
    B, KW, S1, C, C_sp = 2, 16, 50, 40, 12
    inputs = wordend_microbench.make_inputs(B, KW, S1, C, C_sp, seed=3)
    w_state, w_score, combo, emis = inputs
    # WORD_NONE slots: the kernel's pre must be BIG there
    w_state[0, :3] = 7
    combo[7, 0] = we.WORD_NONE
    kernel = jwe.make_kernel(B, KW, S1, C, C_sp)
    outs = kernel(jnp.asarray(w_state).reshape(-1), jnp.asarray(w_score)[:, None, :],
                  jnp.asarray(combo), jnp.asarray(emis).reshape(B, C // 4, 4))
    want = [o[:, 0, :] if o.ndim == 3 and o.shape[1] == 1 else o for o in outs]
    got = _port_wordend(inputs, C_sp)
    _assert_bit_equal(got, want)
    assert (got[0][0, :3] == np.float32(1e30)).all()


@pytest.mark.parametrize("S,C,N", [(100, 16, 64), (37, 5, 19), (1, 3, 0)])
def test_row_gather_plain_equals_xla_gather(jgather, S, C, N):
    table, idx = gather_microbench.make_inputs(S, C, N, seed=S)
    before = rg.row_gather.launches
    got = rg.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert rg.row_gather.launches == before
    want = np.asarray(jgather.xla_gather(jnp.asarray(table), jnp.asarray(idx)))
    assert got.dtype == torch.int32 and got.shape == (N, C)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_gather_plain_equals_pallas_kernel_interpreted(jgather, monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    S, C, N = 100, 16, 64
    table, idx = gather_microbench.make_inputs(S, C, N, seed=5)
    want = np.asarray(jgather.make_pallas_gather(S, C, N)(jnp.asarray(idx), jnp.asarray(table)))
    got = rg.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["state_dtype", "score_dtype", "strided", "shape", "combo"])
def test_wordend_wrapper_rejects_what_the_kernel_does_not_take(bad):
    w_state, w_score, combo, emis = (
        torch.from_numpy(x) for x in wordend_microbench.make_inputs(2, 8, 20, 12, 4)
    )
    c_sp = 4
    if bad == "state_dtype":
        w_state = w_state.long()
    elif bad == "score_dtype":
        w_score = w_score.double()
    elif bad == "strided":
        w_score = torch.cat([w_score, w_score], dim=1)[:, ::2]
    elif bad == "shape":
        w_score = w_score[:, :7].contiguous()
    else:
        c_sp = 17
    with pytest.raises((TypeError, ValueError)):
        we.wordend_block(w_state, w_score, combo, emis, c_sp)


@pytest.mark.parametrize("bad", ["dtype", "rank", "strided"])
def test_row_gather_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table, idx = (torch.from_numpy(x) for x in gather_microbench.make_inputs(10, 4, 6))
    if bad == "dtype":
        idx = idx.long()
    elif bad == "rank":
        idx = idx[:, None]
    else:
        table = table.T
    with pytest.raises((TypeError, ValueError)):
        rg.row_gather(table, idx)


def test_microbench_entry_points_refuse_the_cpu():
    with pytest.raises(ValueError):
        wordend_microbench.run("cpu")
    with pytest.raises(ValueError):
        gather_microbench.run("cpu")
    with pytest.raises(ValueError):
        kernel_bench.run("cpu")
