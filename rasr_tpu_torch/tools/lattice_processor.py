"""lattice-processor tool (ref: src/Tools/LatticeProcessor/ — the legacy
pre-FLF lattice tool; its surviving production use is ACOUSTIC lattice
rescoring via Speech::LatticeExtractor: re-align each word arc under a
new acoustic model, typically to prepare discriminative-training
lattices or rescore with an adapted AM).

Same op surface as flf-tool (the FLF toolkit subsumed the legacy tool
upstream too), with the legacy defaults: ``ops = rescore-am write``.
The acoustic rescoring itself lives in lattice/rescore.py (one batched
banded-Viterbi call per lattice) and is shared with flf-tool's
``rescore-am`` op.

    [lattice-processor]
    lattice-archive = in.cache
    feature-cache   = feat.cache
    lexicon-file    = lexicon.xml
    mixture-file    = adapted.mix
    output-archive  = rescored.cache
"""

from __future__ import annotations

from ..utils.component import ParameterString
from .flf_tool import FlfTool


class LatticeProcessorTool(FlfTool):
    name = "lattice-processor"
    description = "legacy lattice processing (acoustic rescoring + flf ops)"
    ops = ParameterString("ops", default="rescore-am write")


if __name__ == "__main__":
    raise SystemExit(LatticeProcessorTool.main())
