"""RNN-fused streaming decode of a 2-minute utterance at fixed memory.

The port's copy of ``examples/rnn_streaming_long.py``: a 2-minute
synthetic utterance (12,000 frames) streams through the fused decoder in
4-second blocks. The pool is compacted between feeds to the <= 2K rows the
live beam and the frozen finals reach, so it holds 2K + R x Tb rows after
every feed (printed), where an offline pool would need R x T + 1; the
first 8 seconds are checked against an offline fused decode of the same
prefix.

Run: ``python -m rasr_tpu_torch.examples.rnn_streaming_long`` (on the card;
``RNNL_DEVICE=cpu`` runs it on the CPU).
"""

import os
import time

import numpy as np

from ..corpus.lexicon import Lexicon, build_default_silence
from ..device import resolve
from ..models.hmm import HmmTopology, TransitionModel
from ..models.lm.arpa import NgramLm
from ..models.lm.ngram import compile_ngram
from ..models.lm.rnn import RnnLm
from ..models.tying import MonophoneStateTying
from ..search.decoder import BeamConfig, TreeDecoder
from ..search.rnn_fusion import build_rnn_fusion
from ..search.streaming import StreamingDecoder
from ..search.tree import build_prefix_tree


def run(device=None, T: int = 12000, Tb: int = 400, Tp: int = 800) -> dict:
    """Stream T frames in blocks of Tb on ``device`` (the card when None),
    the first Tp against the offline decode; returns the pool's row counts,
    the wall time and the result."""
    device = resolve(device)
    rng = np.random.default_rng(0)
    lex = Lexicon()
    build_default_silence(lex)
    words = []
    for w, pron in enumerate(
        [["a", "b"], ["b", "a"], ["a", "a"], ["b", "b", "a"], ["a", "b", "b"]]
    ):
        lex.add_lemma([f"W{w}"], [(pron, 0.0)])
        words.append(f"W{w}")
    sents = [[words[int(rng.integers(5))] for _ in range(6)] for _ in range(200)]
    lm = NgramLm.train_from_text(sents, order=3)
    tables = compile_ngram(lm)
    rnn = RnnLm.train_from_text(sents, embed_dim=16, hidden_dim=32, epochs=8, device=device)
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    tree = build_prefix_tree(lex, tying, topo, TransitionModel(), lm_vocab=lm.vocab)
    fusion = build_rnn_fusion(rnn, lm.vocab, weight=0.5, device=device)

    K, R = 96, 16
    dec = TreeDecoder(
        tree, tables,
        BeamConfig(max_hyps=K, beam=1e9, word_end_limit=R, root_hyps=64, lm_scale=1.0),
        rnn_fusion=fusion, device=device,
    )
    M = tying.num_classes
    emis = rng.uniform(0.0, 5.0, size=(1, T, M)).astype(np.float32)

    # offline cross-check on a prefix (the offline pool for the whole
    # utterance is the R x T shape the compaction avoids)
    off = dec.decode_scores(emis[:, :Tp], np.array([Tp], np.int32))

    sd = StreamingDecoder(dec).restart(1, n_frames=np.array([T], np.int32))
    t0 = time.time()
    pool_rows = set()
    for lo in range(0, T, Tb):
        sd.feed(emis[:, lo: lo + Tb])
        pool_rows.add(int(sd._carry.cs.shape[1]))
    (res,) = sd.finalize()
    dt = time.time() - t0

    cap = 2 * K + R * Tb
    assert pool_rows == {cap}, pool_rows
    print(f"frames={T} blocks={T // Tb} pool_rows={cap} (constant; an offline pool "
          f"would need {R * T + 1})")
    print(f"decode {dt:.1f}s wall, score={res.score:.2f}, "
          f"{len(res.words)} words; first 10: {' '.join(res.words[:10])}")

    sd2 = StreamingDecoder(dec).restart(1, n_frames=np.array([Tp], np.int32))
    for lo in range(0, Tp, Tb):
        sd2.feed(emis[:, lo: lo + Tb])
    (pre,) = sd2.finalize()
    assert abs(pre.score - off[0].score) < 1e-3 and pre.words == off[0].words
    print(f"{Tp}-frame prefix: streaming == offline fused decode (score {pre.score:.3f}) OK")
    return dict(pool_rows=sorted(pool_rows), seconds=dt, result=res)


if __name__ == "__main__":
    run("cpu" if os.environ.get("RNNL_DEVICE") == "cpu" else None)
