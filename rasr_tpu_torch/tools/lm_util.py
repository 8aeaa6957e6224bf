"""lm-util tool (ref: src/Tools/Lm/): perplexity / LM checks / compile.

The n-gram actions are host work; an RNN LM scores on the tool's
``device`` (the card unless the configuration names another).
"""

from __future__ import annotations

import json
import math
from typing import List

from ..corpus.bliss import CorpusDescription
from ..models.lm.arpa import NgramLm
from ..models.lm.ngram import compile_ngram
from ..utils.component import ParameterChoice, ParameterString
from .application import Application


class LmUtilTool(Application):
    name = "lm-util"
    description = "LM perplexity, statistics, table compilation check"

    action = ParameterChoice(
        "action", ["perplexity", "statistics", "compile-check"], default="statistics"
    )
    lm_file = ParameterString("lm-file")
    #: "ngram" reads ARPA; "rnn" loads an RnnLm image (<path>.json +
    #: <path>.pt; perplexity only — n-gram-table actions need ARPA)
    lm_type = ParameterChoice("lm-type", ["ngram", "rnn"], default="ngram")
    corpus_file = ParameterString("corpus-file", default="")

    def run(self, args: List[str]) -> int:
        if self.lm_type == "rnn":
            from ..models.lm.rnn import RnnLm

            assert self.action == "perplexity", "rnn LM supports perplexity only"
            lm = RnnLm.load(self.lm_file, device=self.torch_device)
        else:
            lm = NgramLm.read_arpa(self.lm_file)
        if self.action == "statistics":
            by_order = {}
            for g in lm.ngrams:
                by_order[len(g)] = by_order.get(len(g), 0) + 1
            info = {"order": lm.order, "vocab": len(lm.vocab), "ngrams": by_order}
            print(json.dumps(info, indent=2))
            return 0
        if self.action == "compile-check":
            tables = compile_ngram(lm)
            info = {
                "states": tables.num_states,
                "table_size": tables.table_size,
                "max_probe": tables.max_probe,
            }
            print(json.dumps(info, indent=2))
            return 0
        # perplexity over corpus orths
        corpus = CorpusDescription.load(self.corpus_file)
        total_cost, total_tokens = 0.0, 0
        for seg in corpus.segments():
            toks = seg.orth.split()
            if not toks:
                continue
            total_cost += lm.sequence_score(toks)
            total_tokens += len(toks) + 1
        ppl = math.exp(total_cost / max(total_tokens, 1))
        print(json.dumps({"perplexity": ppl, "tokens": total_tokens}))
        self.log("perplexity", perplexity=ppl, tokens=total_tokens)
        return 0


if __name__ == "__main__":
    raise SystemExit(LmUtilTool.main())
