"""PyTorch port vs JAX: sequence parallelism (``parallel/sequence.py``).

The time axis over the 4 data ranks of a gloo world
(``tests/torch_parallel_ranks.py``), the JAX side on conftest's 8 virtual
CPU devices. ``SpFrontend``'s assembled chunks equal the dense
``FeatureFrontend`` of both packages and the JAX ``SpFrontend`` (2e-4,
3e-4 with LDA, 3e-3 under sliding CMVN: its statistics are differences of
cumulative sums taken in another order, as the reference allows), and an
utterance too short for its halos raises; ``sp_viterbi_align`` equals
``viterbi_align`` of both packages exactly (states) and within 1e-5
(costs). The reference's cases (``tests/test_sequence_parallel.py``,
``slow`` there) are ``slow`` here too, and also hold each rank to the
JAX sharded functions; two smaller cases run in the default tier against
the dense functions.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rasr_tpu.ops.frontend import FeatureFrontend as JaxFrontend
from rasr_tpu.ops.frontend import FrontendConfig as JaxConfig
from rasr_tpu.ops.viterbi import viterbi_align as jax_viterbi_align
from rasr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rasr_tpu.parallel.sequence import SpFrontend as JaxSpFrontend
from rasr_tpu.parallel.sequence import sp_viterbi_align as jax_sp_viterbi_align
from rasr_tpu_torch.ops.frontend import FeatureFrontend, FrontendConfig
from rasr_tpu_torch.ops.viterbi import viterbi_align
from tests.test_sequence_parallel import _random_hmm, _tones
from tests.torch_parallel_ranks import run_world

FRONTENDS = {
    "segment+splice": (dict(normalize="segment"), dict(splice_context=4), 2e-4),
    "none+deltas": (dict(normalize="none"), dict(delta_order=2), 2e-4),
    # sliding-window statistics from cumulative sums in another order
    "sliding+both": (dict(normalize="sliding", norm_window=40),
                     dict(splice_context=2, delta_order=1), 3e-3),
}


def _frontend_case(name, seconds=1.2, lda_dim=0, splice=None):
    rng = np.random.default_rng(12345)
    cfg, kw, tol = FRONTENDS[name]
    kw = dict(kw)
    if splice is not None:
        kw["splice_context"] = splice
    samples, lengths = _tones(rng, seconds=seconds)
    if lda_dim:
        kw["lda"] = rng.normal(size=(16 * (2 * kw["splice_context"] + 1), lda_dim)).astype(
            np.float32)
        tol = 3e-4
    return dict(cfg=cfg, kw=kw, samples=samples, lengths=lengths, tol=tol)


def _viterbi_case(B, T, S, n):
    rng = np.random.default_rng(12345)
    return _random_hmm(rng, B, T, S) + (np.array(n, np.int32),)


TIER1 = {
    "frontend": _frontend_case("segment+splice", seconds=0.6),
    "viterbi": _viterbi_case(3, 37, 9, [37, 25, 11]),
}
FULL = {
    **{f"frontend:{k}": _frontend_case(k) for k in FRONTENDS},
    "frontend:lda": _frontend_case("segment+splice", seconds=0.9, lda_dim=12),
    "frontend:too-short": _frontend_case("segment+splice", seconds=0.2, splice=6),
    "viterbi:dense": _viterbi_case(3, 37, 9, [37, 25, 11]),
    "viterbi:edges": _viterbi_case(2, 30, 6, [1, 30]),
}


def _rank_cases(cases):
    out = []
    for name, c in cases.items():
        if name.startswith("frontend"):
            fe_kw = dict(cfg=FrontendConfig(**c["cfg"]), **c["kw"])
            out.append((name, "sp_frontend", (4, 1), dict(
                fe_kw=fe_kw, samples=c["samples"], lengths=c["lengths"])))
        else:
            out.append((name, "sp_viterbi", (4, 1), dict(arrays=c)))
    return out


@pytest.fixture(scope="module")
def tier1_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("sp-world"), _rank_cases(TIER1))


@pytest.fixture(scope="module")
def full_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("sp-world-full"), _rank_cases(FULL))


def _check_frontend(outs, c, jax_data=None):
    """Each rank's assembled chunks == the dense frontends (and the JAX
    ``SpFrontend`` over ``jax_data`` devices, when given)."""
    port = FeatureFrontend(FrontendConfig(**c["cfg"]), device="cpu", **c["kw"])
    ref, n_ref = port(c["samples"], c["lengths"])
    dense, _ = JaxFrontend(JaxConfig(**c["cfg"]), **c["kw"])(c["samples"], c["lengths"])
    tol = c["tol"]
    np.testing.assert_allclose(ref.numpy(), np.asarray(dense), rtol=tol, atol=tol)
    wants = [ref.numpy(), np.asarray(dense)]
    if jax_data:
        jsp, jn_sp = JaxSpFrontend(JaxFrontend(JaxConfig(**c["cfg"]), **c["kw"]),
                                   jax_make_mesh(data=jax_data, model=8 // jax_data))(
            c["samples"], c["lengths"])
        np.testing.assert_array_equal(np.asarray(jn_sp), n_ref.numpy())
        wants.append(np.asarray(jsp))
    T = ref.shape[1]
    for out in outs:
        np.testing.assert_array_equal(out["n"], n_ref.numpy())
        for want in wants:
            np.testing.assert_allclose(out["feats"][:, :T], want, rtol=tol, atol=tol)
        assert not out["feats"][:, T:].any()  # frames past the end are zero


def _check_viterbi(outs, arrays, jax_data=None):
    """Each rank's alignment == ``viterbi_align`` of both packages (and the
    JAX ``sp_viterbi_align`` over ``jax_data`` devices, when given)."""
    import torch

    jb, js = jax_viterbi_align(*(jnp.asarray(a) for a in arrays))
    pb, ps = viterbi_align(*(torch.as_tensor(a) for a in arrays))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    bests = [np.asarray(jb), pb.numpy()]
    if jax_data:
        jspb, jsps = jax_sp_viterbi_align(jax_make_mesh(data=jax_data, model=8 // jax_data),
                                          *arrays)
        np.testing.assert_array_equal(np.asarray(jsps), np.asarray(js))
        bests.append(np.asarray(jspb))
    for out in outs:
        np.testing.assert_array_equal(out["states"], np.asarray(js))
        for best in bests:
            np.testing.assert_allclose(out["best"], best, rtol=1e-5)


def test_sp_frontend_small(tier1_world):
    """Segment CMVN + splice over 4 time chunks of 0.6 s."""
    _check_frontend(tier1_world["frontend"], TIER1["frontend"])


def test_sp_viterbi_small(tier1_world):
    _check_viterbi(tier1_world["viterbi"], TIER1["viterbi"])


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_sp_frontend_matches_dense(full_world, name):
    _check_frontend(full_world[f"frontend:{name}"], FULL[f"frontend:{name}"], jax_data=4)


@pytest.mark.slow
def test_sp_frontend_with_lda(full_world):
    _check_frontend(full_world["frontend:lda"], FULL["frontend:lda"], jax_data=8)


@pytest.mark.slow
def test_sp_frontend_rejects_too_short(full_world):
    """18 frames in chunks of 5 cannot hold a splice halo of 6."""
    for out in full_world["frontend:too-short"]:
        assert "sequence parallelism" in str(out["error"])


@pytest.mark.slow
def test_sp_viterbi_matches_dense(full_world):
    _check_viterbi(full_world["viterbi:dense"], FULL["viterbi:dense"], jax_data=4)


@pytest.mark.slow
def test_sp_viterbi_edge_lengths(full_world):
    """n = 1 and n = T utterances; T not a multiple of the axis."""
    _check_viterbi(full_world["viterbi:edges"], FULL["viterbi:edges"], jax_data=8)
