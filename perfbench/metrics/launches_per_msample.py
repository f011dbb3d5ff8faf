"""Kernel launches per million samples in the traced window: the host's
CUDA runtime and driver launch calls (``*LaunchKernel*``) over the traced
samples."""

from perfbench import trace


def read(run):
    if run.trace is None or run.window.samples <= 0:
        return None
    return trace.launches(run.trace.runtime) / (run.window.samples / 1e6)
