"""rasr_tpu_torch — the PyTorch / CUDA port of rasr_tpu for NVIDIA Hopper.

Mirrors ``rasr_tpu``'s layout and names. Plain tensor code is PyTorch;
every Pallas kernel of the ported path is a hand-written CUDA kernel for
``sm_90a`` under ``csrc/``, built with nvcc at first use
(``_build.py``). Imports ``torch`` and never ``jax``; the JAX-free host
modules (lexicon, HMM topology, tying, allophones, ARPA parsing) are
shared with ``rasr_tpu``.

Ported so far (the decode path): ``ops.frontend`` (MFCC / CMVN / splice
/ LDA), ``models.gmm`` + ``models.scorer`` (GMM scoring),
``models.lm.ngram`` (hash-table n-gram LM), ``search.tree`` (within-word
prefix tree) and ``search.decoder`` (frame-synchronous beam search).
"""

__version__ = "0.1.0"
