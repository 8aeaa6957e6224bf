"""Per-layer metric readers, one file per metric, named as the metric.

Each defines ``read(inputs) -> float | None``. ``inputs`` is what a job
gathered in a traced run: ``summary`` (``trace.Summary`` of the profiled
sub-window), ``work`` (``counts.Work`` per span of that sub-window),
``steps`` (frame or training steps per span there) and ``window``
(``{job: (Work, seconds)}`` of the measured window). A reader that finds
nothing to read returns None, and the metric is left out of the line.
"""


def roofline(inputs, span: str):
    """The least time of the span's work over the device time its span
    launched, in percent."""
    work = inputs.get("work", {}).get(span)
    summary = inputs.get("summary")
    if work is None or summary is None or summary.spans[span].device_s <= 0:
        return None
    return 100.0 * work.least_seconds() / summary.spans[span].device_s


def mfu(inputs, job: str):
    """The least time of the window's model operations, each precision at
    its peak, over the window, in percent."""
    got = inputs.get("window", {}).get(job)
    if got is None:
        return None
    work, seconds = got
    return 100.0 * work.op_seconds() / seconds


def idle(inputs, job: str):
    """The share of the traced sub-window with nothing running on the device."""
    if job not in inputs.get("window", {}) or inputs.get("summary") is None:
        return None
    return 100.0 * inputs["summary"].idle_share


def per_step(inputs, span: str):
    """Kernel launches inside the span per step it took."""
    steps = inputs.get("steps", {}).get(span)
    summary = inputs.get("summary")
    if not steps or summary is None:
        return None
    return summary.spans[span].kernels / steps
