"""The share of the decoder's frame steps replayed from a CUDA graph: the
program's ``graph_steps`` count over its ``steps`` count, summed over the
``decode.dispatch`` spans made outside the profiled batch, in percent. A
program whose spans carry no ``graph_steps`` gives none."""

from benchmark.metrics._program import unprofiled


def read(inputs):
    spans = [sp for sp in unprofiled("decode.dispatch") if "graph_steps" in sp.counts]
    steps = sum(sp.counts["steps"] for sp in spans)
    if not steps:
        return None
    return 100.0 * sum(sp.counts["graph_steps"] for sp in spans) / steps
