"""rasr_tpu_torch — the PyTorch / CUDA port of rasr_tpu for NVIDIA Hopper.

Mirrors ``rasr_tpu``'s layout and names. Plain tensor code is PyTorch;
every Pallas kernel of the ported path is a hand-written CUDA kernel for
``sm_90a`` under ``csrc/``, built with nvcc at first use
(``_build.py``). Imports ``torch`` and never ``jax``, nor ``rasr_tpu``:
it carries its own copies of the JAX-free host modules (lexicon, HMM
topology, tying, allophones, ARPA parsing, statistics, logging, cache
archives, audio input, Bliss corpora, the evaluator).

Ported so far (the decode paths): ``ops.frontend`` (MFCC with energy /
CMVN per segment or sliding / deltas / VTLN / splice / LDA), ``ops.dsp``
and ``ops.gammatone`` (the other front ends), ``models.gmm`` + ``models.scorer`` (GMM scoring), ``models.nn``
(NN acoustic models and the hybrid scorer), ``models.lm.ngram``
(hash-table n-gram LM), ``search.tree`` (the within-word and across-word
networks), ``search.lookahead`` (bigram / trigram LM lookahead),
``search.decoder`` (frame-synchronous beam search, the best path walked
back on the device), ``search.wfst`` and ``fsa`` (general WFST networks,
weighted automata), ``models.lm.grammar`` (the FSA grammar LM), ``search.streaming`` (block-feed online decoding),
``lattice`` (word lattices from a decode's records, WER and the lattice
oracle), ``pipeline`` (corpus visitor, feature caches and the offline
recognizer) and ``bench`` (``python -m rasr_tpu_torch.bench``, the
counterpart of ``bench.py``, with its ``BENCH_TRAIN=1`` training step).

The training side: ``ops.viterbi`` (banded Viterbi and forward-backward),
``align`` (alignment graphs, batched forced alignment),
``lattice.rescore`` (acoustic lattice rescoring) and ``train`` (GMM EM,
LDA, fMLLR and MLLR, VTLN factor estimation, training checkpoints, frame
and sequence CE training, LF-MMI and sMBR).

The documented entry points: ``tools`` (``python -m
rasr_tpu_torch.tools.<tool>``, the reference's 13 tools over
``utils.config`` / ``utils.component``, on the card unless the config
names another ``device``) and the production LM path (``utils.native``,
the port's build of ``native/*.cc``; ``models.lm.packed``;
``models.lm.classlm``; LM images in ``models.lm.ngram``; ``models.cart``).
"""

__version__ = "0.1.0"
