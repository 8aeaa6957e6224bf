"""fsa tool (ref: src/Tools/Fsa/): CLI automata operations over ATT files.

    python -m rasr_tpu_torch.tools.fsa_tool --fsa.op=best in.att
    python -m rasr_tpu_torch.tools.fsa_tool --fsa.op=compose a.att b.att --fsa.output=c.att
"""

from __future__ import annotations

from typing import List

from ..fsa.algorithms import (
    best, compose, concatenate, determinize, invert, minimize,
    n_best_paths, project, prune, push_weights, remove_epsilon, union,
)
from ..fsa.automaton import Automaton
from ..utils.component import ParameterChoice, ParameterFloat, ParameterInt, ParameterString
from .application import Application


class FsaTool(Application):
    name = "fsa"
    description = "weighted automata operations (ATT format)"

    op = ParameterChoice(
        "op",
        ["best", "nbest", "compose", "determinize", "minimize", "prune",
         "push", "remove-epsilon", "project-input", "project-output",
         "invert", "union", "concat", "draw", "info"],
        default="info",
    )
    output = ParameterString("output", default="")
    threshold = ParameterFloat("threshold", default=10.0)
    n = ParameterInt("n", default=5)

    def run(self, args: List[str]) -> int:
        fsas = [Automaton.read_att(p) for p in args]
        a = fsas[0] if fsas else None
        out = None
        if self.op == "info":
            print(f"states={a.num_states} arcs={a.num_arcs} finals={len(a.finals)}")
        elif self.op == "best":
            cost, path = best(a)
            print(cost, " ".join(str(arc.ilabel) for arc in path))
        elif self.op == "nbest":
            for cost, labels in n_best_paths(a, self.n):
                print(cost, " ".join(map(str, labels)))
        elif self.op == "draw":
            print(a.draw_dot())
        elif self.op == "compose":
            out = compose(fsas[0], fsas[1])
        elif self.op == "union":
            out = union(fsas[0], fsas[1])
        elif self.op == "concat":
            out = concatenate(fsas[0], fsas[1])
        elif self.op == "determinize":
            out = determinize(a)
        elif self.op == "minimize":
            out = minimize(a)
        elif self.op == "prune":
            out = prune(a, self.threshold)
        elif self.op == "push":
            out = push_weights(a)
        elif self.op == "remove-epsilon":
            out = remove_epsilon(a)
        elif self.op == "project-input":
            out = project(a, "input")
        elif self.op == "project-output":
            out = project(a, "output")
        elif self.op == "invert":
            out = invert(a)
        if out is not None:
            target = self.output or "out.att"
            out.write_att(target)
            self.log("written", output=target, states=out.num_states, arcs=out.num_arcs)
        return 0


if __name__ == "__main__":
    raise SystemExit(FsaTool.main())
