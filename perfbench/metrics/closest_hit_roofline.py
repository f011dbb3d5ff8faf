"""The closest-hit and shadow queries' share of their roofline, in %: the
least time the queries of the traced window need on an H100, over the
device time of those queries.

Least time: bytes over the HBM peak (the work is bytes-bound: a pair test
is some hundred FLOP against a primitive's 16 or 36 bytes, read once a
query). Each executed ray query, closest-hit or shadow (the renderer's
stats: queries and shadow queries executed), reads its ray once (origin,
direction, t_min: 28 bytes) and writes its hit once (t, index: 8 bytes);
each query call reads the scene's primitives once (a sphere's centre and
radius, 16 bytes; a triangle's vertex and two edges, 36 bytes).

Device time: every kernel, copy and set that the profiler correlates with
a launch made inside a query call (``perfbench.trace.span_queries``),
whatever route answers it: the march kernel with its cull and sorts, the
sweep kernels, the "tensor" route's matrix product with its elementwise
epilogue. Nothing is read where no query ran on the device.
"""

from perfbench import trace
from perfbench.peaks import PEAK_BYTES

RAY_BYTES = 28 + 8
SPHERE_BYTES, TRIANGLE_BYTES = 16, 36


def needed_bytes(ray_queries: float, calls: int, spheres: int,
                 triangles: int, shadow_rays: float = 0.0) -> float:
    return ((ray_queries + shadow_rays) * RAY_BYTES
            + calls * (spheres * SPHERE_BYTES + triangles * TRIANGLE_BYTES))


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window_ns
    busy = sum(min(e, hi) - max(s, lo)
               for s, e in trace.union(run.trace.query_device)) / 1e9
    if busy <= 0:
        return None
    need = needed_bytes(run.window.stats[0], run.trace.query_calls,
                        run.spheres, run.triangles, run.window.stats[1])
    return 100.0 * need / PEAK_BYTES / busy
