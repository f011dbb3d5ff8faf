"""Host waits on the device per million samples in the traced window: the
CUDA runtime and driver calls that synchronise (stream, device and event
synchronise, blocking copies; ``perfbench/trace.SYNC_CALLS``), less the
harness's own, over the traced samples."""

from perfbench import trace


def read(run):
    if run.trace is None or run.window.samples <= 0:
        return None
    n = trace.syncs(run.trace.runtime) - run.harness_syncs
    return n / (run.window.samples / 1e6)
