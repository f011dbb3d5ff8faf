"""Share of the traced window, in %, in which the host waited on a device
value on the render path: the union of the program's ``pt.wait`` spans
(the bounce loop's test, the chunk keys, the once-a-pass read of the
query counters) inside the window (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    waits = spans.of(run, spans.WAIT)
    if not waits:
        return None
    lo, hi = run.trace.window_ns
    return 100.0 * spans.length(spans.clipped_union(waits, lo, hi)) / (
        hi - lo)
