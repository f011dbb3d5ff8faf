"""Timing and throughput instrumentation (``utils/metrics.py``).

- :func:`span`: the program's spans, recorded on the profiler's clock
  into :data:`SPANS` while a ``torch.profiler`` records, and nothing
  otherwise: ``pt.pass`` (a pass of ``Renderer.render_passes``),
  ``pt.bounce`` (a trip of the integrator's bounce loop), ``pt.light``
  (a bounce's next-event-estimation work, its shadow query included),
  ``pt.query`` (a closest-hit or shadow query, at its call site),
  ``pt.cull`` (the cluster march's host work before its launch,
  ``ops/cluster_sweep.march_inputs``, inside its ``pt.query``),
  ``pt.cull2`` (inside a ``pt.cull``: the preparation run as torch ops,
  ``march_inputs_reference``, on a cull plan that the preparation kernels
  do not take, the two-level cull or superclusters) and ``pt.wait`` (a
  host read of a device value on the render path);
- :func:`mrays_per_s`: the nominal throughput, pixels x spp x depth
  closest-hit queries per wall-second;
- :func:`trace_context`: a ``torch.profiler`` scope that writes a Chrome
  trace (the reference's is a ``jax.profiler`` trace) carrying the
  program's spans;
- :func:`card_line` and :func:`card_stamp`: the card's name, power limit,
  SM clock and temperature from ``nvidia-smi``, stamped beside every
  number measured on it;
- the H100's peak rates and the float32 operations of one (ray,
  primitive) pair test, from which bounds and utilizations are computed
  (``chip_smoke.py``, ``bench.py``).

Nothing here imports torch at module level.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import subprocess
import time
from typing import Iterator, Optional

TRACE_FILE = "trace.json"

# The spans recorded while a profiler records, in the order they close (a
# parent after its children), as (start_ns, end_ns, name, args) on the
# profiler's clock (Unix time in ns, as time.time_ns gives it). Bounded:
# the oldest fall out.
SPANS: collections.deque = collections.deque(maxlen=1 << 18)
# set while trace_context records: the spans then also enter the profile
_annotate = False

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W power limit): HBM
# bytes/s and float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# 32-bit integer operations a second: 64 INT32 lanes per SM (the Hopper
# white paper) against 128 float32 lanes that count 2 FLOP per FMA, so a
# quarter of PEAK_F32 (132 SMs x 64 x 1.98 GHz)
PEAK_INT32 = PEAK_F32 / 4
# int32 operations of one threefry2x32 block (20 rounds of add, rotate and
# xor, 5 key injections of 3 sums, the key schedule) and of turning a word
# into a float in [0, 1) (shift, or, subtract): the draws kernel's bound
OPS_THREEFRY = 20 * 3 + 5 * 3 + 2 + 2
OPS_TO_UNIT = 3
# float32 operations per (ray, primitive) pair: 23 per pair scalar (12
# products, 11 sums) times the scalars the primitive needs (sphere 2,
# triangle 4), its epilogue (sphere 14, triangle 13) and the merge compare
OPS_SPHERE_PAIR = 2 * 23 + 14 + 1
OPS_TRI_PAIR = 4 * 23 + 13 + 1
# ... of which a pair needs only these where its result cannot depend on
# the rest (the dense and window sweeps skip the rest there): a sphere its
# two pair scalars and the discriminant test (the roots only where disc >=
# 0), a triangle det, b1 * det, b2 * det and the barycentric tests (t * det
# and the t tests only where those pass)
OPS_SPHERE_BASE = 2 * 23 + 4
OPS_TRI_BASE = 3 * 23 + 9
# float32 operations of the BVH traversal kernel (csrc/bvh_traverse.cu):
# per ray the three reciprocals of d; per node visit the slab test (6
# differences, 6 products, 3 swap tests, 6 running-bound compares, the
# final compare); per primitive tested (a leaf whose box is hit) the direct
# sphere test (3 differences, 3 dot products of 5, r * r and its
# difference, the discriminant's 3, its test, sqrt, 1 / a, the two roots'
# 4, 4 range compares, the hit test) or Moller-Trumbore (2 cross products
# of 9, 3 differences, 4 dot products of 5, 1 / det and its test, 3
# products by it, b1 + b2, 9 compares), each with the t < t_best compare
OPS_TRAV_RAY = 3
OPS_BOX_VISIT = 6 + 6 + 3 + 6 + 1
OPS_SPHERE_TEST = 3 + 3 * 5 + 2 + 3 + 1 + 1 + 1 + 4 + 4 + 1 + 1
OPS_TRI_TEST = 2 * 9 + 3 + 4 * 5 + 2 + 3 + 1 + 9 + 1

# the fields of card_stamp, as nvidia-smi names them
STAMP_FIELDS = ("name", "power.limit", "clocks.sm", "temperature.gpu")


def nvidia_smi(fields) -> list:
    """The first card's values of ``fields`` (nvidia-smi ``--query-gpu``
    names), as nvidia-smi prints them; raises if nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return ", ".join(nvidia_smi(("name", "power.limit")))


def card_stamp() -> dict:
    """The card that a measurement ran on: ``name``, ``power_limit``,
    ``clocks_sm`` and ``temperature`` from nvidia-smi (its strings, units
    included), and ``count``, the CUDA devices this process sees."""
    import torch
    values = nvidia_smi(STAMP_FIELDS)
    keys = ("name", "power_limit", "clocks_sm", "temperature")
    return dict(zip(keys, values), count=torch.cuda.device_count())


def mrays_per_s(num_pixels: int, spp: int, max_depth: int,
                seconds: float) -> float:
    """Closest-hit queries per wall-second, in millions, of the nominal
    workload (pixels x spp x depth). Paths end early, so fewer queries
    execute: this is an upper bound on the achieved per-query rate, for
    comparing workloads; the executed count is ``render_sum``'s."""
    if seconds <= 0:
        return float("inf")
    return num_pixels * spp * max_depth / seconds / 1e6


@functools.lru_cache(maxsize=None)
def _autograd_profiler():
    from torch.autograd import profiler
    return profiler


class _Span:
    __slots__ = ("name", "args", "start", "annotation")

    def __init__(self, name: str, args):
        self.name, self.args = name, args
        self.annotation = None

    def __enter__(self):
        if _annotate:
            self.annotation = _autograd_profiler().record_function(
                self.name, None if self.args is None else str(self.args))
            self.annotation.__enter__()
        self.start = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        SPANS.append((self.start, end, self.name, self.args))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """A span of the program named ``name`` (``args``: any value, the
    pass's samples, a bounce's depth, a query's kind, a wait's site),
    recorded into :data:`SPANS` while a ``torch.profiler`` records, and
    under :func:`trace_context` also into its trace as a
    ``record_function`` range. With no profiler recording it is one flag
    check and a shared null context.

    Spans nest on the host thread: ``pt.pass`` holds the ``pt.bounce``
    trips of its chunks, a bounce its ``pt.query`` calls and, under NEE,
    its ``pt.light`` spans, which hold the shadow queries; a march
    query holds its ``pt.cull``, and that its ``pt.cull2`` on the
    two-level cull; ``pt.wait`` sits where the host waits
    (the bounce loop's test sits between bounces). Their times are on the
    profiler's clock, the one its device intervals are on, so an idle
    stretch of the device falls inside the span the host was in. Outside :func:`trace_context` they stay out of
    the profile: the profiler mirrors a range onto the device's timeline
    around the work launched in it, where a reader of device intervals
    would take it for work."""
    if not _autograd_profiler()._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` scope (host activity, and the card's where
    there is one) when ``log_dir`` is set, writing the Chrome trace
    ``log_dir/trace.json`` on exit; a no-op otherwise. The trace carries
    the program's spans (:func:`span`: ``pt.pass``, ``pt.bounce``,
    ``pt.light``, ``pt.query``, ``pt.cull``, ``pt.cull2``, ``pt.wait``)
    as ranges around the work they hold.
    Synchronise inside the scope, so the card's work falls in it:

        with trace_context("out/trace"):
            img = render(scene, cam).cpu()
    """
    global _annotate
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _annotate = True
        try:
            yield
        finally:
            _annotate = False
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
