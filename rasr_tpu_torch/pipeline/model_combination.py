"""Model combination: lexicon + acoustic model + LM with global scales.

Re-implements the reference's model-combination object
(ref: src/Speech/ModelCombination.*, src/Mc/ — the {lexicon, acoustic
model, language model} bundle with am-scale / lm-scale /
pronunciation-scale that every consumer is configured with).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..corpus.lexicon import Lexicon
from ..models.hmm import HmmTopology, TransitionModel
from ..models.scorer import FeatureScorer
from ..models.tying import StateTying


@dataclasses.dataclass
class ModelCombination:
    lexicon: Lexicon
    tying: StateTying
    topology: HmmTopology
    transitions: TransitionModel
    scorer: FeatureScorer
    lm: Optional[object] = None  # host LanguageModel
    lm_tables: Optional[object] = None  # compiled device tables
    am_scale: float = 1.0
    lm_scale: float = 1.0
    pronunciation_scale: float = 1.0

    def __post_init__(self):
        # am scale folds into the scorer, pronunciation scale into tree
        # building; lm scale is applied by the decoder/rescorer.
        if hasattr(self.scorer, "scale"):
            self.scorer.scale = self.am_scale
