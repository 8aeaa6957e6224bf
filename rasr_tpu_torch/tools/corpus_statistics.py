"""corpus-statistics tool (ref: src/Tools/CorpusStatistics/)."""

from __future__ import annotations

import json
from typing import List

from ..corpus.bliss import CorpusDescription
from ..utils.component import ParameterString
from .application import Application


class CorpusStatisticsTool(Application):
    name = "corpus-statistics"
    description = "segment/duration/speaker statistics of a corpus"

    corpus_file = ParameterString("corpus-file")

    def run(self, args: List[str]) -> int:
        corpus = CorpusDescription.load(self.corpus_file)
        stats = corpus.statistics()
        words = 0
        vocab = set()
        for seg in corpus.segments():
            toks = seg.orth.split()
            words += len(toks)
            vocab.update(toks)
        stats["words"] = words
        stats["distinct_words"] = len(vocab)
        print(json.dumps(stats, indent=2))
        self.log("corpus statistics", **stats)
        return 0


if __name__ == "__main__":
    raise SystemExit(CorpusStatisticsTool.main())
