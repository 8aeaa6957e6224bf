"""PyTorch port vs JAX: banded Viterbi and forward-backward (``ops/viterbi.py``).

The same seeded numpy instances (ragged batches, disabled skips, padded
states) go through both packages on the CPU. Tolerances: Viterbi state
sequences exact and best costs 1e-5 relative; forward-backward totals
1e-5 relative and gammas 1e-5 absolute; the gradient of the total (the
LF-MMI numerator's) 1e-5 absolute. The reference's brute-force oracles
(``tests/test_viterbi.py``) run on the port's side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rasr_tpu.ops import viterbi as jv
from rasr_tpu_torch.ops import viterbi as tv
from rasr_tpu_torch.ops.viterbi import BIG
from tests.test_viterbi import _oracle_paths, _path_cost, _random_instance

VIT_RTOL = 1e-5
FB_RTOL, GAMMA_ATOL, GRAD_ATOL = 1e-5, 1e-5, 1e-5


def _instance(seed, B=4, T=9, S=6, pad_states=0, zero_row=False, one_frame=False):
    """_random_instance plus padded states (BIG everywhere, as
    ``_pad_graphs`` pads), and optionally an utterance of 0 frames or one
    of a single frame (that may end in its start state)."""
    rng = np.random.default_rng(seed)
    arrays = list(_random_instance(rng, B=B, T=T, S=S))
    if pad_states:
        for i in range(1, 6):
            pad = np.full((B, pad_states), BIG, np.float32)
            arrays[i] = np.concatenate([arrays[i], pad], axis=1)
        arrays[0] = np.concatenate(
            [arrays[0], rng.uniform(0, 5, size=(B, T, pad_states)).astype(np.float32)], axis=2)
    if zero_row:
        arrays[6] = arrays[6].copy()
        arrays[6][-1] = 0
    if one_frame:
        arrays[6] = arrays[6].copy()
        arrays[6][0] = 1
        arrays[5][0, 0] = 0.5
    return arrays


def _torch(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [dict(seed=s) for s in range(4)] + [
    dict(seed=7, pad_states=3), dict(seed=8, T=12, S=4), dict(seed=9, zero_row=True),
    dict(seed=10, one_frame=True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_viterbi_matches_jax(case):
    arrays = _instance(**case)
    jb, js = jv.viterbi_align(*_jax(arrays))
    tb, ts = tv.viterbi_align(*_torch(arrays))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=VIT_RTOL)
    # the backpointers too (int8, row 0 zero)
    _, jf, jbp = jv.viterbi_forward(*_jax(arrays))
    _, tf, tbp = tv.viterbi_forward(*_torch(arrays))
    assert tbp.dtype == torch.int8
    np.testing.assert_array_equal(tbp.numpy(), np.asarray(jbp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_viterbi_ties_break_as_jax():
    """Equal candidates everywhere: argmin takes the first of
    [loop, fwd, skip] in both packages."""
    B, T, S = 2, 8, 5
    emis = np.zeros((B, T, S), np.float32)
    loop = np.ones((B, S), np.float32)
    fwd = np.ones((B, S), np.float32)
    fwd[:, 0] = BIG
    skip = np.ones((B, S), np.float32)
    skip[:, :2] = BIG
    init = np.full((B, S), BIG, np.float32)
    init[:, 0] = 0.0
    final = np.zeros((B, S), np.float32)
    n = np.array([8, 6], np.int32)
    arrays = [emis, loop, fwd, skip, init, final, n]
    jb, js = jv.viterbi_align(*_jax(arrays))
    tb, ts = tv.viterbi_align(*_torch(arrays))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_forward_backward_matches_jax(case):
    arrays = _instance(**case)
    jt, jg = jv.forward_backward(*_jax(arrays))
    tt, tg = tv.forward_backward(*_torch(arrays))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=FB_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=GAMMA_ATOL)
    # the forward pass alone gives the same total
    np.testing.assert_allclose(tv.forward_total(*_torch(arrays)).numpy(), np.asarray(jt),
                               rtol=FB_RTOL)


@pytest.mark.parametrize("total_of", ["forward_backward", "forward_total"])
@pytest.mark.parametrize("case", [dict(seed=3), dict(seed=7, pad_states=3),
                                  dict(seed=9, zero_row=True)],
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_total_gradient_matches_jax(case, total_of):
    """d total / d emissions == JAX's gradient (the state occupancies), and
    finite where states are padded (BIG) or an utterance is empty."""
    arrays = _instance(**case)
    rest_j, rest_t = _jax(arrays[1:]), _torch(arrays[1:])
    want = jax.grad(lambda e: jv.forward_backward(e, *rest_j)[0].sum())(jnp.asarray(arrays[0]))
    e = torch.from_numpy(arrays[0]).requires_grad_(True)
    fn = getattr(tv, total_of)
    total = fn(e, *rest_t)
    total = total[0] if isinstance(total, tuple) else total
    total.sum().backward()
    assert torch.isfinite(e.grad).all()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want), atol=GRAD_ATOL)


# ------------------------------------ the reference's oracles, on the port
def test_viterbi_matches_bruteforce(rng):
    emis, loop, fwd, skip, init, final, n_frames = _random_instance(rng)
    best, states = tv.viterbi_align(*_torch([emis, loop, fwd, skip, init, final, n_frames]))
    best, states = best.numpy(), states.numpy()
    for b in range(emis.shape[0]):
        n = int(n_frames[b])
        paths = _oracle_paths(emis[b], loop[b], fwd[b], skip[b], init[b], final[b], n)
        assert paths, "oracle found no path"
        ocost, opath = min(paths, key=lambda p: p[0])
        np.testing.assert_allclose(best[b], ocost, rtol=1e-5)
        assert list(states[b, :n]) == opath or np.isclose(
            _path_cost(emis[b], loop[b], fwd[b], skip[b], init[b], final[b], states[b, :n]),
            ocost, rtol=1e-5)
        assert np.all(states[b, n:] == -1)


def test_forward_backward_total_matches_bruteforce(rng):
    emis, loop, fwd, skip, init, final, n_frames = _random_instance(rng, B=2, T=5, S=4)
    total, gamma = tv.forward_backward(*_torch([emis, loop, fwd, skip, init, final, n_frames]))
    total, gamma = total.numpy(), gamma.numpy()
    for b in range(2):
        n = int(n_frames[b])
        paths = _oracle_paths(emis[b], loop[b], fwd[b], skip[b], init[b], final[b], n)
        ocost = -np.log(np.sum(np.exp(-np.array([c for c, _ in paths]))))
        np.testing.assert_allclose(total[b], ocost, rtol=1e-4)
        post = np.exp(-(np.array([c for c, _ in paths]) - ocost))
        occ = np.zeros((n, emis.shape[2]))
        for p, (c, path) in zip(post, paths):
            for t, s in enumerate(path):
                occ[t, s] += p
        np.testing.assert_allclose(gamma[b, :n], occ, atol=1e-4)
        np.testing.assert_allclose(gamma[b, :n].sum(-1), 1.0, atol=1e-4)
        np.testing.assert_allclose(gamma[b, n:].sum(-1), 0.0, atol=1e-6)


def test_viterbi_prefers_cheap_path():
    T, S = 4, 3
    emis = np.full((1, T, S), 10.0, np.float32)
    for t, s in enumerate([0, 0, 1, 2]):
        emis[0, t, s] = 0.0
    loop = np.zeros((1, S), np.float32)
    fwd = np.zeros((1, S), np.float32)
    fwd[:, 0] = BIG
    skip = np.full((1, S), BIG, np.float32)
    init = np.full((1, S), BIG, np.float32)
    init[0, 0] = 0
    final = np.full((1, S), BIG, np.float32)
    final[0, -1] = 0
    best, states = tv.viterbi_align(*_torch([emis, loop, fwd, skip, init, final,
                                             np.array([T], np.int32)]))
    assert states[0].tolist() == [0, 0, 1, 2]
    np.testing.assert_allclose(best[0].item(), 0.0, atol=1e-6)


def test_single_frame_utterance(rng):
    S = 3
    emis = rng.uniform(0, 5, size=(1, 4, S)).astype(np.float32)
    loop = np.zeros((1, S), np.float32)
    fwd = np.zeros((1, S), np.float32)
    fwd[:, 0] = BIG
    skip = np.full((1, S), BIG, np.float32)
    init = np.zeros((1, S), np.float32)
    final = np.zeros((1, S), np.float32)
    best, states = tv.viterbi_align(*_torch([emis, loop, fwd, skip, init, final,
                                             np.array([1], np.int32)]))
    b = int(np.argmin(emis[0, 0]))
    assert states[0, 0].item() == b
    assert (states[0, 1:] == -1).all()
    np.testing.assert_allclose(best[0].item(), emis[0, 0, b], rtol=1e-6)


def test_empty_utterance():
    """n_frames == 0: cost BIG, every frame -1, total 0 and no gamma."""
    arrays = _instance(9, zero_row=True)
    best, states = tv.viterbi_align(*_torch(arrays))
    assert best[-1].item() == np.float32(BIG) and (states[-1] == -1).all()
    total, gamma = tv.forward_backward(*_torch(arrays))
    assert total[-1].item() == 0.0 and gamma[-1].abs().sum().item() == 0.0
