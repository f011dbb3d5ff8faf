"""Share of the traced window, in %, in which no kernel, copy or set ran
on the device: 100 x (1 - the union of the device's intervals over the
window's length)."""

from perfbench import trace


def read(run):
    if run.trace is None:
        return None
    span = run.trace.window_ns[1] - run.trace.window_ns[0]
    if span <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_ns(run.trace) / span)
