"""Seconds from the harness's start to the first timed pass: imports, the
program's kernels and host library (built or loaded from the checkout),
the scene, its closest-hit tables and one warm pass."""


def read(run):
    return run.setup_s
