"""The port's streaming decoder: streamed == offline, and == the JAX one.

``StreamingDecoder`` feeds blocks of frames through the decoder's own
block step (the offline decode is one block), so a stream that covers
each utterance's frames must give the offline words, word ends, record
chains and scores exactly, for any block split, declared or undeclared
lengths and feeds past the end, under every beam and network of
``tests/test_torch_decoder.py``. Against the JAX ``StreamingDecoder``
(``tests/test_decoder.py:300,324``, ``tests/test_crossword.py:284``) the
port agrees on ``current_best()`` at a mid frontier and on
``finalize()``, on the decoder tests' tie-free fixtures (scores within
1e-4 relative, as there).
"""

import numpy as np
import pytest
import torch

from rasr_tpu.models.lm.ngram_tpu import compile_ngram as jax_compile_ngram
from rasr_tpu.search import decoder as jdec
from rasr_tpu.search.streaming import StreamingDecoder as JaxStreamingDecoder
from rasr_tpu_torch.models.lm.ngram import compile_ngram
from rasr_tpu_torch.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu_torch.search.streaming import StreamingDecoder
from tests.test_torch_decoder import (  # noqa: F401 (module-scoped fixtures)
    SLICE_B, SLICE_C, slice_b_systems, slice_c_systems,
)

T = 14
N = np.array([14, 11, 9])
SPLITS = {
    "blocks-divide": [7, 7],
    "blocks-ragged": [5, 5, 4],
    "one-frame": [1] * T,
    "one-block": [T],
}


def _emissions(seed, M=20011):
    """The decoder parity tests' tie-free draw (``_assert_port_equals_jax``)."""
    return np.random.default_rng(seed).uniform(0.0, 6.0, size=(3, T, M)).astype(np.float32)


def _stream(decoder, emis, n, split):
    sd = StreamingDecoder(decoder).restart(emis.shape[0], n)
    t = 0
    for size in split:
        sd.feed(emis[:, t:t + size])
        t += size
    assert sd.frames_fed == t
    return sd


def _assert_same(got, want, rtol=0.0):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.words == b.words
        assert a.word_ends == b.word_ends
        assert a.record_ids == b.record_ids
        np.testing.assert_allclose(a.score, b.score, rtol=rtol)


def _slice_b_decoder(slice_b_systems, name="root-select-deferred"):
    homophones, kw = SLICE_B[name]
    tying, lm, jtree, ttree, _ = slice_b_systems[homophones]
    return (TreeDecoder(ttree, compile_ngram(lm), BeamConfig(**kw), device="cpu"),
            jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig(**kw)),
            100 + sorted(SLICE_B).index(name))


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_streamed_equals_offline(slice_b_systems, split):
    """Ragged declared lengths; blocks that divide T, that do not, single
    frames and one block: the same results, records and final beams."""
    decoder, _, seed = _slice_b_decoder(slice_b_systems)
    emis = _emissions(seed)
    offline = decoder.decode_scores_device(emis, N)
    sd = _stream(decoder, emis, N, SPLITS[split])
    streamed = sd.finalize_device()
    _assert_same(decoder.results_from_device(streamed), decoder.results_from_device(offline))
    for a, b in zip(streamed.records, offline.records):
        assert torch.equal(a, b)
    for a, b in zip(streamed.finals, offline.finals):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SLICE_C))
def test_streamed_equals_offline_on_every_network(slice_c_systems, name):
    """Compact slots, the across-word network, bigram and trigram
    lookahead under "arc" and "survivor" updates: blocks of 5 frames."""
    network, la, kw = SLICE_C[name]
    lm, (_, ttree), las = slice_c_systems[network]
    decoder = TreeDecoder(ttree, compile_ngram(lm), BeamConfig(**kw),
                          bigram_la=las[la][1] if la else None, device="cpu")
    emis = _emissions(200 + sorted(SLICE_C).index(name))
    _assert_same(_stream(decoder, emis, N, SPLITS["blocks-ragged"]).finalize(),
                 decoder.decode_scores(emis, N))


def test_undeclared_length_finalizes_at_the_frontier(slice_b_systems):
    """No n_frames: every utterance stays live, and finalize() at frame T
    equals the offline decode of T frames each."""
    decoder, _, seed = _slice_b_decoder(slice_b_systems)
    emis = _emissions(seed)
    sd = StreamingDecoder(decoder).restart(3)
    for lo in range(0, T, 4):
        sd.feed(torch.from_numpy(emis[:, lo:lo + 4]))
    _assert_same(sd.finalize(), decoder.decode_scores(emis, np.full(3, T)))


def test_feeding_past_the_end_freezes_rows(slice_b_systems):
    """Declared lengths below the frames fed: those rows freeze at their
    end, as padding frames do offline. (Lengths as a tensor here, numpy
    arrays elsewhere.)"""
    decoder, _, seed = _slice_b_decoder(slice_b_systems)
    emis = _emissions(seed)
    short = np.array([9, 6, 4])
    _assert_same(_stream(decoder, emis, torch.from_numpy(short), [5, 5, 4]).finalize(),
                 decoder.decode_scores(emis, short))


def test_current_best_leaves_the_stream_unchanged(slice_b_systems):
    """current_best() at every frontier is the offline decode of the
    frames so far (lengths capped there), and the final result is the
    offline one, as if it had never been asked."""
    decoder, _, seed = _slice_b_decoder(slice_b_systems)
    emis = _emissions(seed)
    sd = StreamingDecoder(decoder).restart(3, N)
    for t in range(0, T, 3):
        sd.feed(emis[:, t:t + 3])
        fed = sd.frames_fed
        _assert_same(sd.current_best(),
                     decoder.decode_scores(emis[:, :fed], np.minimum(N, fed)))
    _assert_same(sd.finalize(), decoder.decode_scores(emis, N))
    with pytest.raises(RuntimeError, match="no frames fed"):
        StreamingDecoder(decoder).restart(3).finalize()
    with pytest.raises(RuntimeError, match="restart"):
        StreamingDecoder(decoder).feed(emis)
    with pytest.raises(ValueError, match="batch"):
        StreamingDecoder(decoder).restart(2).feed(emis)


def _port_vs_jax(decoder, jax_decoder, emis):
    """current_best() after 7 frames (two utterances still live) and
    finalize() after all, fed in blocks of 4, 3, 4, 3."""
    sd = StreamingDecoder(decoder).restart(3, N)
    jsd = JaxStreamingDecoder(jax_decoder).restart(3, N)
    for lo, hi in ((0, 4), (4, 7)):
        sd.feed(emis[:, lo:hi])
        jsd.feed(emis[:, lo:hi])
    _assert_same(sd.current_best(), jsd.current_best(), rtol=1e-4)
    for lo, hi in ((7, 11), (11, 14)):
        sd.feed(emis[:, lo:hi])
        jsd.feed(emis[:, lo:hi])
    handle = sd.finalize_device()
    _assert_same(decoder.results_from_device(handle), jsd.finalize(), rtol=1e-4)
    # every frame's records (the reference pads its buffer past frame T)
    lemma, score, prev, _, word, _ = jax_decoder._last_records
    np.testing.assert_array_equal(handle.records.lemma.numpy(), lemma[:T])
    np.testing.assert_array_equal(handle.records.prev.numpy(), prev[:T])
    np.testing.assert_array_equal(handle.records.word.numpy(), word[:T])
    np.testing.assert_allclose(handle.records.score.numpy(), score[:T], rtol=1e-4)


def test_streaming_matches_jax(slice_b_systems):
    """Root select and deferred emission under binding K, H, Kb and R."""
    decoder, jax_decoder, seed = _slice_b_decoder(slice_b_systems)
    _port_vs_jax(decoder, jax_decoder, _emissions(seed))


@pytest.mark.parametrize("name", ["bigram-arc-production", "across-word"])
def test_streaming_matches_jax_slice_c(slice_c_systems, name):
    """The word-set bigram lookahead under root select and deferred
    emission, and the across-word network (tests/test_crossword.py:284)."""
    network, la, kw = SLICE_C[name]
    lm, (jtree, ttree), las = slice_c_systems[network]
    pair = las[la] if la else (None, None)
    decoder = TreeDecoder(ttree, compile_ngram(lm), BeamConfig(**kw), bigram_la=pair[1],
                          device="cpu")
    jax_decoder = jdec.TreeDecoder(jtree, jax_compile_ngram(lm), jdec.BeamConfig(**kw),
                                   bigram_la=pair[0])
    _port_vs_jax(decoder, jax_decoder, _emissions(200 + sorted(SLICE_C).index(name)))
