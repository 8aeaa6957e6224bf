"""The host-side (numpy / pure Python) modules the port shares with rasr_tpu.

These import no jax, so the port uses them as they are: the lexicon
(``rasr_tpu.corpus.lexicon``), HMM topology and transition model
(``models.hmm``), allophones (``models.allophone``), state tying
(``models.tying``) and the ARPA n-gram model (``models.lm.arpa``).
``tests/test_torch_no_jax.py`` holds the port to that with jax made
unimportable.
"""

from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.allophone import Allophone, AllophoneState
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.tying import MonophoneStateTying, StateTying

__all__ = [
    "Allophone", "AllophoneState", "HmmTopology", "Lexicon", "MonophoneStateTying",
    "NgramLm", "StateTying", "Tdp", "TransitionModel", "build_default_silence",
]
