"""The share of the decoder's host time spent waiting on the card at the
best-path read: the program's ``decode.read.wait`` spans over its
``decode.dispatch`` and ``decode.read`` spans, summed over the decodes
(outside the profiled batch), in percent."""

from benchmark.metrics._program import unprofiled


def ns(spans):
    return sum(sp.end_ns - sp.start_ns for sp in spans)


def read(inputs):
    wait, dispatch, reads = (unprofiled(n) for n in
                             ("decode.read.wait", "decode.dispatch", "decode.read"))
    if not wait or not dispatch:
        return None
    return 100.0 * ns(wait) / (ns(dispatch) + ns(reads))
