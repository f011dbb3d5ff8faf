"""The cluster march kernel's (K1, ``cluster_march_kernel``) share of its
roofline on the work it executed, in %: the least time that work needs
on an H100, over the device time of the kernel in the traced window (the
union of its intervals).

The work: the march's executed (ray, primitive slot) pair tests, the
renderer's third stat (``render_sum``: every slot a chunk marches tests
its ``RAY_TILE`` lanes against the cluster's ``K`` rows). Its least time
is the larger of

- operations: ``OPS_PAIR`` float32 operations a pair test (the four pair
  scalars of a primitive, each a 12-feature contraction of 12 products
  and 11 sums, the triangle's epilogue of 13 and the merge compare: 4 x
  23 + 13 + 1 = 106) over the float32 peak;
- bytes: each marched slot reads its cluster's table, ``SLOT_TABLE_BYTES``
  (12 features x 4 pair scalars x 64 rows x 4 bytes = 12,288), and its
  128 rays, ``SLOT_RAY_BYTES`` (a ray's origin, direction and t_min, 28
  bytes, and its hit's t and index, 8: 128 x 36 = 4,608), over the HBM
  peak.

Nothing is read without a march interval in the window (another route,
or the CPU's profile).
"""

from perfbench import trace
from perfbench.peaks import PEAK_BYTES, PEAK_F32

KERNEL = "cluster_march_kernel"
K, RAY_TILE = 64, 128
OPS_PAIR = 4 * (12 + 11) + 13 + 1
SLOT_TABLE_BYTES = 12 * 4 * K * 4
SLOT_RAY_BYTES = RAY_TILE * (28 + 8)


def needed_ops(pair_tests: float) -> float:
    return pair_tests * OPS_PAIR


def needed_bytes(pair_tests: float) -> float:
    slots = pair_tests / (K * RAY_TILE)
    return slots * (SLOT_TABLE_BYTES + SLOT_RAY_BYTES)


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window_ns
    march = [x for x in run.trace.device if KERNEL in x[2]]
    busy = sum(min(e, hi) - max(s, lo) for s, e in trace.union(march)
               if e > lo and s < hi) / 1e9
    if busy <= 0:
        return None
    pairs = run.window.stats[2]
    least = max(needed_ops(pairs) / PEAK_F32,
                needed_bytes(pairs) / PEAK_BYTES)
    return 100.0 * least / busy
