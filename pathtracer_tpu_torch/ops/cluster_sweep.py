"""Cluster-culled closest-hit (``ops/cluster_sweep.py``): two strategies
over the same cluster tables.

"march" (``cluster_march``, the default), per query:

1. cull: slab-test every ray against the regular cluster AABBs, giving
   conservative entry distances (C_reg, R);
2. bin: one sort groups rays by (nearest, last) touched cluster; dead and
   untouched lanes sort last (skipped by the shadow query, whose rays
   already come in the order of the hits they start from);
3. order: each chunk of ``ray_tile`` rays gets its clusters in ascending
   chunk-entry order, plus a +BIG sentinel slot; each lane gets a stop gate
   (its farthest touched entry, nudged up);
4. march: one launch of the CUDA kernel (``csrc/cluster_march.cu``) walks
   every chunk's order until no remaining cluster can beat any lane;
5. residual: the huge prims (backdrop spheres) are swept densely for every
   ray and merged; a cluster hit must beat the residual strictly;
6. unsort by ray id, unless the caller keeps the sorted order
   (``extras``, the sorted-wavefront integrator).

Steps 1-3 and the residual sweep are :func:`march_inputs`. On the card,
under the flat cull plan (no cull2, ``sup`` 1, at most
``CULL2_CLUSTERS`` clusters), they are two more kernels of
``csrc/cluster_march.cu``: ``march_bin`` (steps 1-2: each lane's bin key,
then one stable ``torch.sort``; only when the rays are sorted) and
``march_order`` (steps 1 and 3 and the residual: the sorted rays, phi,
the gates, every chunk's order and the residual winners), which recompute
each lane's entries instead of keeping the (C_reg, R) cull. Everywhere
else, and always on the CPU, their plain twin
:func:`march_inputs_reference` runs them as torch ops.

Large scenes (2,048 regular clusters or more, :func:`cull_plan`) take the
reference's two-level cull, "cull2": steps 1-3 work on superclusters of
``sup`` consecutive clusters (the per-ray cull stays near R x 512 entries
instead of R x C_reg), each lane's gate is its farthest touched
supercluster exit, and each chunk orders the clusters themselves by the
interval cull of its ray bundle. The march kernel does not change; steps
1-3 stay torch ops on every device, each query's under a ``pt.cull2``
span and counted by ``MARCH_PREP_TWIN``.

Exact: each chunk stops only once every lane's best hit precedes all its
unvisited clusters. Ties between different primitives at bit-equal t may
pick another winner than the dense sweep's lowest-index rule.

"rounds" (``cluster_closest``), the reference's cross-check strategy:
a residual pass over the residual tile, then up to ``max_rounds`` rounds
of (sort rays by their nearest unprocessed beatable cluster, sweep a
window of W consecutive clusters per chunk, re-cull), then an exact
full-width fallback for the rays still unresolved. Every sweep is one
launch of the window kernel (``csrc/window_sweep.cu``).

Each kernel has two implementations: the CUDA kernel for tensors on a GPU,
and a plain PyTorch twin (``march_reference``, ``window_reference``,
``march_inputs_reference``) for tensors on the CPU. ``march`` and
``window_sweep`` pick by device only; on a GPU they launch the kernel or
raise. ``march_inputs`` picks by what it observes: the device and the
cull plan.
"""
from __future__ import annotations

import ctypes
import os

import torch

from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
from pathtracer_tpu_torch.core import vec
from pathtracer_tpu_torch.ops import _cuda_build
from pathtracer_tpu_torch.ops.clusters import K_RES, ClusterTables
from pathtracer_tpu_torch.ops.tensor_sweep import (BIG, FEAT, OUTS,
                                                   _epilogue, check_ranges,
                                                   contract, ray_features)
from pathtracer_tpu_torch.utils import metrics

DEF_RAY_TILE = 128
DEF_WINDOW = 4       # clusters per round's window
DEF_MAX_ROUNDS = 6
# the cull plan's default switch to the two-level cull, in regular clusters,
# and the most the preparation kernels take under a flat plan (their boxes
# and a chunk's order live in shared memory: kMaxPrepClusters in
# csrc/cluster_march.cu)
CULL2_CLUSTERS = 2048
STRATEGIES = ("march", "rounds")
# round key of a resolved lane: sorts after every cluster index
_RESOLVED_KEY = 0x3FFFFFFF

# Conservative shrink of cluster entry distances: slab-test and epilogue
# arithmetic differ at ulp level, so a hit exactly on a cluster boundary
# could otherwise be ordered wrongly.
_ENTRY_MARGIN = 1e-4

# Launches of the CUDA march, preparation (march_bin and march_order) and
# window kernels in this process (each wrapper adds one per launch and
# nowhere else), the march route's shadow queries (one march each: on
# the card a launch that MARCH_LAUNCHES counts too, elsewhere a call of the
# twin) and the preparations run as torch ops on a plan the preparation
# kernels do not take (march_inputs' twin under cull2 or superclusters);
# callers reset them to 0 to count a run.
MARCH_LAUNCHES = 0
MARCH_PREP_LAUNCHES = 0
MARCH_PREP_TWIN = 0
MARCH_SHADOW_LAUNCHES = 0
WINDOW_LAUNCHES = 0

# the most extras that ride march_order (PrepExtras::kMax in
# csrc/cluster_march.cu)
PREP_MAX_EXTRAS = 8


class _PrepExtras(ctypes.Structure):
    """march_order's PrepExtras: the 4-byte (R,) extras it gathers."""
    _fields_ = [("src", ctypes.c_void_p * PREP_MAX_EXTRAS),
                ("dst", ctypes.c_void_p * PREP_MAX_EXTRAS),
                ("stride", ctypes.c_longlong * PREP_MAX_EXTRAS),
                ("n", ctypes.c_int)]


_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_MARCH_PROTOTYPES = {
    "cluster_march_launch": (
        [_P] * 5 + [_I] * 4 + [_P] * 3 + [_I, _F, _F] + [_P] * 4),
    "march_bin_launch": [_P] * 3 + [_L, _L] + [_P] * 2 + [_I, _F]
    + [_P] * 3,
    "march_order_launch": [_P] * 4 + [_L] + [_I] * 3 + [_P] * 2
    + [_F, _F, _I] + [_P] * 3 + [_I, _I] + [_P] * 11 + [_PrepExtras, _P]}
_WINDOW_PROTOTYPES = {"window_sweep_launch": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3)}


def _cull_T(o, d, active, cmin, cmax, t_min, with_exit: bool = False):
    """Conservative per-(cluster, ray) entry distances, (C, R) f32; BIG
    where the slab test misses or the ray is inactive. NaN-dropping
    selects (``where(near > tn, near, tn)``) let ``0 * inf`` fall through
    to the running bound, so d == 0 components are safe.

    ``with_exit`` also returns the raw slab exits (-BIG where the test
    misses): the cull2 stop gate, since any hit a lane can still find lies
    inside a touched box's [entry, exit]."""
    inv = 1.0 / d
    shape = (cmin.shape[0], o.shape[0])
    tn = torch.full(shape, t_min, dtype=torch.float32, device=o.device)
    tf = torch.full(shape, BIG, dtype=torch.float32, device=o.device)
    for ax in range(3):
        inv_ax = inv[None, :, ax]
        lo = (cmin[:, ax:ax + 1] - o[None, :, ax]) * inv_ax
        hi = (cmax[:, ax:ax + 1] - o[None, :, ax]) * inv_ax
        swap = inv_ax < 0.0
        near = torch.where(swap, hi, lo)
        far = torch.where(swap, lo, hi)
        tn = torch.where(near > tn, near, tn)
        tf = torch.where(far < tf, far, tf)
    hit = ~(tf < tn) & active[None, :]
    entry = tn - (_ENTRY_MARGIN * torch.abs(tn) + 1e-6)
    entry = torch.where(hit, entry, BIG)
    if with_exit:
        return entry, torch.where(hit, tf, -BIG)
    return entry


def _chunk_interval_cull(o, d, active, cmin, cmax, t_min, n_chunks,
                         ray_tile):
    """Conservative per-(chunk, cluster) entry lower bounds, (n_chunks, C)
    f32: the cull2 march's member-granularity order.

    An interval-arithmetic slab test of each chunk's ray bundle (the box
    hull of its active lanes' origins times the interval hull of their
    directions) against every cluster box. It lower-bounds every active
    lane's margined entry, and is BIG where every lane provably misses or
    the chunk has no active lane. An axis whose direction interval spans
    zero bounds nothing (its 1/d interval is unbounded). O(n_chunks x C)
    where the per-ray cull is O(R x C)."""
    o3 = o.reshape(n_chunks, ray_tile, 3)
    d3 = d.reshape(n_chunks, ray_tile, 3)
    m = active.reshape(n_chunks, ray_tile, 1)
    o_lo = torch.amin(torch.where(m, o3, BIG), dim=1)     # (n_chunks, 3)
    o_hi = torch.amax(torch.where(m, o3, -BIG), dim=1)
    d_lo = torch.amin(torch.where(m, d3, BIG), dim=1)
    d_hi = torch.amax(torch.where(m, d3, -BIG), dim=1)
    any_live = torch.any(m[:, :, 0], dim=1)               # (n_chunks,)
    C = cmin.shape[0]
    tn = torch.full((n_chunks, C), t_min, dtype=torch.float32,
                    device=o.device)                       # LB of tn
    tf = torch.full((n_chunks, C), BIG, dtype=torch.float32,
                    device=o.device)                       # UB of tf
    for ax in range(3):
        dl = d_lo[:, ax:ax + 1]
        dh = d_hi[:, ax:ax + 1]
        # a direction interval touching zero leaves 1/d unbounded; the eps
        # also guards a subnormal 1/d overflowing to inf
        span0 = (dl <= 1e-30) & (dh >= -1e-30)
        ia = 1.0 / dh
        ib = 1.0 / dl
        inv_lo = torch.minimum(ia, ib)
        inv_hi = torch.maximum(ia, ib)
        pl_lo = cmin[None, :, ax] - o_hi[:, ax:ax + 1]     # (n_chunks, C)
        pl_hi = cmin[None, :, ax] - o_lo[:, ax:ax + 1]
        ph_lo = cmax[None, :, ax] - o_hi[:, ax:ax + 1]
        ph_hi = cmax[None, :, ax] - o_lo[:, ax:ax + 1]

        def ip_lo(a_lo, a_hi):
            return torch.minimum(
                torch.minimum(a_lo * inv_lo, a_lo * inv_hi),
                torch.minimum(a_hi * inv_lo, a_hi * inv_hi))

        def ip_hi(a_lo, a_hi):
            return torch.maximum(
                torch.maximum(a_lo * inv_lo, a_lo * inv_hi),
                torch.maximum(a_hi * inv_lo, a_hi * inv_hi))

        # a lane's near is min(A, B) and its far max(A, B) of its two slab
        # distances (cmax >= cmin)
        near_lb = torch.minimum(ip_lo(pl_lo, pl_hi), ip_lo(ph_lo, ph_hi))
        far_ub = torch.maximum(ip_hi(pl_lo, pl_hi), ip_hi(ph_lo, ph_hi))
        tn = torch.maximum(tn, torch.where(span0, -BIG, near_lb))
        tf = torch.minimum(tf, torch.where(span0, BIG, far_ub))
    miss = tf < tn                      # every lane misses
    ent = tn - (_ENTRY_MARGIN * torch.abs(tn) + 1e-6)
    return torch.where(miss | ~any_live[:, None], BIG, ent)


def cull_plan(C_reg: int, cull2=None, sup=None,
              cull2_clusters: int = CULL2_CLUSTERS):
    """(cull2, sup): the reference's cull plan for C_reg regular clusters.
    ``cull2`` None switches the two-level cull on at ``cull2_clusters``
    clusters or more; ``sup`` None is ceil(C_reg / 512) under cull2 (the
    per-ray cull stays near R x 512) and 1 (no superclusters) without."""
    if cull2 is None:
        cull2 = C_reg >= cull2_clusters
    if sup is None:
        sup = max(1, -(-C_reg // 512)) if cull2 else 1
    if sup < 1:
        raise ValueError(f"supercluster size must be positive, got {sup}")
    return bool(cull2), int(sup)


def _super_boxes(cmin, cmax, sup):
    """The boxes of ``sup`` consecutive clusters (min / max over each
    group; the trailing group padded with inverted boxes)."""
    C_reg = cmin.shape[0]
    pad = -(-C_reg // sup) * sup - C_reg
    smin = torch.cat([cmin, cmin.new_full((pad, 3), BIG)])
    smax = torch.cat([cmax, cmax.new_full((pad, 3), -BIG)])
    return (smin.view(-1, sup, 3).amin(dim=1),
            smax.view(-1, sup, 3).amax(dim=1))


def _cull(o, d, active, cmin, cmax, t_min):
    """Per-(ray, cluster) entry distances, (R, C_reg): the transpose of
    :func:`_cull_T`, whose entries are the same operations per element."""
    return _cull_T(o, d, active, cmin, cmax, t_min).T


def march_reference(phi, a, gate, ids, ents, cols, is_sphere, ranges,
                    K: int, t_min: float, t_max: float, ray_tile: int):
    """Plain PyTorch twin of the CUDA march kernel: same inputs, same
    (t_best (R,) f32, best (R,) int32, slots (n_chunks,) int32).

    Loops over order slots, vectorised over the chunks still marching. A
    chunk marches slot j while max over its lanes of min(t_best, gate)
    exceeds ents[j]; slot j sweeps cluster c = ids[j] over its rows [lo, hi)
    = ranges[c] only, with the pair-scalar contraction and the epilogue,
    each primitive typed by its own is_sphere row, and a lane takes the
    cluster's first minimum only where it is strictly better. Raises
    ValueError where a range leaves [0, K]."""
    check_ranges(ranges, K)
    n_chunks, n_slots = ids.shape
    dev = phi.device
    k = torch.arange(K, device=dev)
    P = phi.view(n_chunks, ray_tile, FEAT)
    A = a.view(n_chunks, ray_tile)
    G = gate.view(n_chunks, ray_tile)
    t_acc = torch.full((n_chunks, ray_tile), BIG, dtype=torch.float32,
                       device=dev)
    b_acc = torch.full((n_chunks, ray_tile), -1, dtype=torch.int32,
                       device=dev)
    slots = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    marching = torch.ones(n_chunks, dtype=torch.bool, device=dev)
    for j in range(n_slots):
        m = torch.amax(torch.minimum(t_acc, G), dim=1)
        marching = marching & (m > ents[:, j])
        live = torch.nonzero(marching).squeeze(1)
        if live.numel() == 0:
            break
        slots += marching.to(torch.int32)
        c = ids[live, j].long()
        rng = ranges[c]
        swept = (k[None, :] >= rng[:, 0:1]) & (k[None, :] < rng[:, 1:2])
        S = contract(P[live], cols[c])                   # (L, T, OUTS*K)
        B, C0 = S[..., 0:K], S[..., K:2 * K]
        D, E = S[..., 2 * K:3 * K], S[..., 3 * K:4 * K]
        t_eff = _epilogue(B, C0, D, E, A[live][:, :, None],
                          is_sphere[c][:, None, :] != 0, swept[:, None, :],
                          t_min, t_max)
        local_j = torch.argmin(t_eff, dim=2)   # first minimum
        local_t = torch.amin(t_eff, dim=2)
        t_prev = t_acc[live]
        better = local_t < t_prev
        glob = (c[:, None] * K + local_j).to(torch.int32)
        t_acc[live] = torch.where(better, local_t, t_prev)
        b_acc[live] = torch.where(better, glob, b_acc[live])
    return t_acc.reshape(-1), b_acc.reshape(-1), slots


def _march_cuda(phi, a, gate, ids, ents, cols, is_sphere, ranges, K, t_min,
                t_max, ray_tile):
    global MARCH_LAUNCHES
    n_chunks, n_slots = ids.shape
    R = n_chunks * ray_tile
    C_tot = cols.shape[0]
    if ray_tile % 32 != 0 or not 0 < ray_tile <= 1024:
        raise ValueError("ray_tile must be a multiple of 32 up to 1024")
    for name, x, dtype, shape in (
            ("phi", phi, torch.float32, (R, FEAT)),
            ("a", a, torch.float32, (R,)),
            ("gate", gate, torch.float32, (R,)),
            ("ids", ids, torch.int32, (n_chunks, n_slots)),
            ("ents", ents, torch.float32, (n_chunks, n_slots)),
            ("cols", cols, torch.float32, (C_tot, FEAT, OUTS * K)),
            ("is_sphere", is_sphere, torch.int32, (C_tot, K)),
            ("ranges", ranges, torch.int32, (C_tot, 2))):
        _cuda_build.check_arg(x, name, dtype, shape, phi.device)
    fn = _cuda_build.load("cluster_march",
                          _MARCH_PROTOTYPES).cluster_march_launch
    t_out = torch.empty(R, dtype=torch.float32, device=phi.device)
    best = torch.empty(R, dtype=torch.int32, device=phi.device)
    slots = torch.empty(n_chunks, dtype=torch.int32, device=phi.device)
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    err = fn(phi.data_ptr(), a.data_ptr(), gate.data_ptr(), ids.data_ptr(),
             ents.data_ptr(), n_chunks, n_slots, ray_tile, C_tot,
             cols.data_ptr(), is_sphere.data_ptr(), ranges.data_ptr(), K,
             t_min, t_max, t_out.data_ptr(), best.data_ptr(),
             slots.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cluster_march kernel launch failed: CUDA error "
                           f"{err}")
    MARCH_LAUNCHES += 1
    return t_out, best, slots


def march(phi, a, gate, ids, ents, cols, is_sphere, ranges, K: int,
          t_min: float, t_max: float, ray_tile: int):
    """The march: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors. phi (R, 12), a = |d|^2, gate (R,), ids / ents (n_chunks,
    n_slots) the clusters of each chunk in marching order and their chunk
    entries, cols (C_tot, 12, 4K), is_sphere (C_tot, K) int32, ranges
    (C_tot, 2) int32: the rows [lo, hi) of each cluster to sweep
    (``ClusterTables.ranges``). Returns (t_best (R,) f32, best (R,) int32,
    slots (n_chunks,) int32); ``best`` is the winner's c * K + k, -1 where
    nothing was hit.

    Every id must lie in [0, C_tot) and every range in [0, K]. The twin
    raises otherwise; the kernel fails a device-side assert, so PyTorch
    raises at the stream's next sync."""
    if phi.device.type == "cuda":
        return _march_cuda(phi, a, gate, ids, ents, cols, is_sphere, ranges,
                           K, t_min, t_max, ray_tile)
    if phi.device.type == "cpu":
        return march_reference(phi, a, gate, ids, ents, cols, is_sphere,
                               ranges, K, t_min, t_max, ray_tile)
    raise ValueError(f"no cluster march for device {phi.device}")


def march_inputs(ct: ClusterTables, o, d, t_min, ray_tile=DEF_RAY_TILE,
                 active=None, extras=None, t_max=None, sort_rays=True,
                 cull2=None, sup=None):
    """Steps 1-3 of the query (cull, bin, order) and the residual sweep:
    :func:`march_inputs_reference`'s arguments and result.

    On CUDA rays under the flat cull plan (no cull2, ``sup`` 1, at most
    ``CULL2_CLUSTERS`` regular clusters), the preparation kernels
    (``march_bin`` where ``sort_rays``, then ``march_order``) compute it,
    bit-equal to the twin; they launch or raise (rays or extras that
    require grad among what they refuse). Every other input takes the
    twin; on a plan the kernels do not take (cull2, ``sup`` > 1 or more
    than ``CULL2_CLUSTERS`` clusters), on any device, that call is a
    ``pt.cull2`` span (inside the caller's ``pt.cull``) and adds one to
    ``MARCH_PREP_TWIN``."""
    global MARCH_PREP_TWIN
    cull2, sup = cull_plan(ct.C_reg, cull2, sup)
    flat = not cull2 and sup == 1 and ct.C_reg <= CULL2_CLUSTERS
    if flat and o.device.type == "cuda":
        return _march_inputs_cuda(ct, o, d, t_min, ray_tile, active, extras,
                                  t_max, sort_rays)
    kw = dict(ray_tile=ray_tile, active=active, extras=extras, t_max=t_max,
              sort_rays=sort_rays, cull2=cull2, sup=sup)
    if flat:
        return march_inputs_reference(ct, o, d, t_min, **kw)
    MARCH_PREP_TWIN += 1
    with metrics.span("pt.cull2"):
        return march_inputs_reference(ct, o, d, t_min, **kw)


def _prep_launched(err: int, name: str, lanes: int) -> None:
    """Raise on a failed launch; count it where it had lanes to take (the
    entry point launches nothing for an empty wavefront)."""
    global MARCH_PREP_LAUNCHES
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if lanes > 0:
        MARCH_PREP_LAUNCHES += 1


def _march_inputs_cuda(ct: ClusterTables, o, d, t_min, ray_tile, active,
                       extras, t_max, sort_rays):
    if t_max is None:
        t_max = BIG
    r = o.shape[0]
    C_reg, K = ct.C_reg, ct.K
    C_tot = ct.cols.shape[0]
    r_pad = -(-r // ray_tile) * ray_tile
    n_chunks = r_pad // ray_tile
    if extras is not None and r_pad != r:
        raise ValueError("extras mode needs a chunk-aligned wavefront")
    if ray_tile % 32 != 0 or not 0 < ray_tile <= 1024:
        raise ValueError("ray_tile must be a multiple of 32 up to 1024")
    dev = o.device
    o, d = o.contiguous(), d.contiguous()
    checks = [("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
              ("cmin", ct.cmin, torch.float32, (C_reg, 3)),
              ("cmax", ct.cmax, torch.float32, (C_reg, 3)),
              ("cols", ct.cols, torch.float32, (C_tot, FEAT, OUTS * K)),
              ("is_sphere", ct.is_sphere, torch.int32, (C_tot, 1, K)),
              ("valid_row", ct.valid_row, torch.int32, (C_tot, 1, K))]
    if active is not None:
        active = active.contiguous()
        checks.append(("active", active, torch.bool, (r,)))
    for name, x, dtype, shape in checks:
        _cuda_build.check_arg(x, name, dtype, shape, dev)
    if sort_rays and extras is not None:
        # the extras ride march_order: up to PREP_MAX_EXTRAS (r,) planes of
        # 4-byte elements, strided or not (the integrator's are at most 8)
        if len(extras) > PREP_MAX_EXTRAS:
            raise ValueError(f"march_order takes at most {PREP_MAX_EXTRAS} "
                             f"extras, got {len(extras)}")
        for e in extras:
            if e.requires_grad:
                raise ValueError("an extra requires grad; pass it detached")
            if e.dim() != 1 or e.shape[0] != r or e.element_size() != 4 \
                    or e.device != dev:
                raise ValueError(f"extras must be ({r},) planes of 4-byte "
                                 f"elements on {dev}, got {e.dtype} "
                                 f"{tuple(e.shape)} on {e.device}")
    lib = _cuda_build.load("cluster_march", _MARCH_PROTOTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mask = active.data_ptr() if active is not None else None
    t_min = float(t_min)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    order = None
    if sort_rays:
        key = empty(r_pad, torch.int32)
        active0 = empty(r_pad, torch.bool)
        _prep_launched(lib.march_bin_launch(
            o.data_ptr(), d.data_ptr(), mask, r, r_pad, ct.cmin.data_ptr(),
            ct.cmax.data_ptr(), C_reg, t_min, key.data_ptr(),
            active0.data_ptr(), stream), "march_bin", r_pad)
        order = rid = torch.sort(key, stable=True).indices
    else:
        rid = empty(r_pad, torch.int64)
    o_s, d_s = empty((r_pad, 3)), empty((r_pad, 3))
    active_s = empty(r_pad, torch.bool)
    phi, a, gate = empty((r_pad, FEAT)), empty(r_pad), empty(r_pad)
    ids = empty((n_chunks, C_reg + 1), torch.int32)
    ents = empty((n_chunks, C_reg + 1))
    t_res, b_res = empty(r_pad), empty(r_pad, torch.int32)
    ride = _PrepExtras()
    if order is not None and extras is not None:
        sorted_extras = tuple(empty(r, e.dtype) for e in extras)
        for i, (e, s) in enumerate(zip(extras, sorted_extras)):
            ride.src[i], ride.dst[i] = e.data_ptr(), s.data_ptr()
            ride.stride[i] = e.stride(0)
        ride.n = len(extras)
        extras = sorted_extras
    res_row = K - K_RES
    _prep_launched(lib.march_order_launch(
        o.data_ptr(), d.data_ptr(), mask,
        None if order is None else order.data_ptr(), r, n_chunks, ray_tile,
        C_reg, ct.cmin.data_ptr(), ct.cmax.data_ptr(), t_min, float(t_max),
        int(t_max < BIG * 0.5), ct.cols[C_reg].data_ptr(),
        ct.is_sphere[C_reg, 0, res_row:].data_ptr(),
        ct.valid_row[C_reg, 0, res_row:].data_ptr(), K, C_reg * K + res_row,
        o_s.data_ptr(), d_s.data_ptr(), active_s.data_ptr(),
        None if order is not None else rid.data_ptr(), phi.data_ptr(),
        a.data_ptr(), gate.data_ptr(), ids.data_ptr(), ents.data_ptr(),
        t_res.data_ptr(), b_res.data_ptr(), ride, stream), "march_order",
        r_pad)
    if order is None:
        active0 = active_s
    args = (phi, a, gate, ids, ents, ct.cols, ct.is_sphere.view(C_tot, K),
            ct.ranges, K, t_min, float(t_max), ray_tile)
    return dict(o=o_s, d=d_s, active=active_s, active0=active0, rid=rid,
                extras=extras, args=args, t_res=t_res, b_res=b_res, r=r,
                cull2=False, sup=1)


def march_inputs_reference(ct: ClusterTables, o, d, t_min,
                           ray_tile=DEF_RAY_TILE, active=None, extras=None,
                           t_max=None, sort_rays=True, cull2=None, sup=None):
    """Plain PyTorch twin of the preparation kernels, and the only
    implementation of the plans they do not take: steps 1-3 of the query
    (cull, bin, order) and the residual sweep as torch ops; ``sort_rays``
    False keeps the caller's lane order (no binning sort).

    The cull plan (:func:`cull_plan`, the reference's rule from C_reg where
    ``cull2`` or ``sup`` is None): with ``sup`` > 1 the per-ray cull, the
    bin key and the gate work on superclusters, the boxes of ``sup``
    consecutive clusters. Without cull2 each supercluster slot of a chunk's
    order expands to its ``sup`` members in id order, each with the
    supercluster's entry (the trailing group repeats the last cluster).
    Under cull2 each lane's gate is its farthest touched supercluster exit,
    and each chunk orders the clusters themselves by the larger of two
    lower bounds of their entry: the interval cull of the chunk's ray
    bundle and their supercluster's chunk entry.

    Returns a dict with the sorted rays (``o``, ``d``, ``active``,
    ``active0`` in caller order, ``rid`` the caller position of each
    sorted lane, ``extras``), the kernel inputs
    (``args`` of :func:`march`: phi, a, gate, ids, ents, cols, is_sphere,
    ranges, K, t_min, t_max, ray_tile), the residual winners (``t_res``,
    ``b_res``) and the plan (``cull2``, ``sup``)."""
    if t_max is None:
        t_max = BIG
    r = o.shape[0]
    C_reg, K = ct.C_reg, ct.K
    cull2, sup = cull_plan(C_reg, cull2, sup)
    dev = o.device
    r_pad = -(-r // ray_tile) * ray_tile
    n_chunks = r_pad // ray_tile
    keep_sorted = extras is not None
    if keep_sorted and r_pad != r:
        raise ValueError("extras mode needs a chunk-aligned wavefront")
    if r_pad != r:
        o = torch.cat([o, o.new_zeros((r_pad - r, 3))])
        d = torch.cat([d, d.new_zeros((r_pad - r, 3))])
        if active is not None:
            active = torch.cat([active, active.new_zeros(r_pad - r)])
    nonzero = torch.any(d != 0.0, dim=1)
    active = nonzero if active is None else active & nonzero
    active0 = active
    t_min = float(t_min)

    if sup > 1:
        cull_min, cull_max = _super_boxes(ct.cmin, ct.cmax, sup)
    else:
        cull_min, cull_max = ct.cmin, ct.cmax
    C_cull = cull_min.shape[0]
    entry = _cull_T(o, d, active, cull_min, cull_max, t_min,
                    with_exit=cull2)                     # (C_cull, R)
    if cull2:
        entry, exit_ = entry
    if sort_rays:
        # two-level bin key (nearest touched box, last touched box);
        # untouched and dead lanes sort strictly last
        touched = entry < BIG * 0.5
        kmin = torch.argmin(entry, dim=0)
        any_t = torch.any(touched, dim=0)
        klast = C_cull - 1 - torch.argmax(touched.flip(0).to(torch.uint8),
                                          dim=0)
        key = torch.where(any_t, kmin * (C_cull + 1) + klast,
                          C_cull * (C_cull + 2))
        order = torch.sort(key, stable=True).indices
        o, d, active = o[order], d[order], active[order]
        # the cull of a ray depends on that ray alone: permuting its
        # columns is the reference's re-cull of the sorted rays
        entry = entry[:, order]
        if cull2:
            exit_ = exit_[:, order]
        if keep_sorted:
            extras = tuple(e[order] for e in extras)
    else:
        order = torch.arange(r_pad, device=dev)
    rid = order

    d_eff = torch.where(active[:, None], d, 0.0)
    phi = ray_features(o, d_eff)
    a = vec.dot(d_eff, d_eff)
    a = torch.where(a == 0.0, 1.0, a)
    # per-lane stop gate: the farthest touched-box entry (under cull2 the
    # farthest touched-supercluster exit), nudged so the lane's own last
    # cluster is still processed; -BIG for lanes touching no regular
    # cluster (and inactive lanes), which drive no march at all
    far = exit_ if cull2 else entry
    gate = torch.amax(torch.where(entry >= BIG * 0.5, -BIG, far), dim=0)
    gate = gate * (1.0 + 1e-5) + 1e-5
    if t_max < BIG * 0.5:
        gate = torch.clamp(gate, max=t_max)
    gate = torch.where(active, gate, -BIG)

    # per-chunk ascending cluster order by chunk entry, + one sentinel slot
    chunk_entry = entry.reshape(C_cull, n_chunks, ray_tile).amin(dim=2).T
    if cull2:
        ivl_entry = _chunk_interval_cull(o, d, active, ct.cmin, ct.cmax,
                                         t_min, n_chunks, ray_tile)
        sup_m = chunk_entry.repeat_interleave(sup, dim=1)[:, :C_reg]
        chunk_entry = torch.maximum(ivl_entry, sup_m)
    ents_sorted, ids_sorted = torch.sort(chunk_entry, dim=1, stable=True)
    if sup > 1 and not cull2:
        # each supercluster slot expands to its members in id order
        ids_sorted = torch.clamp(
            ids_sorted[:, :, None] * sup
            + torch.arange(sup, device=dev)[None, None, :],
            max=C_reg - 1).reshape(n_chunks, -1)
        ents_sorted = ents_sorted.repeat_interleave(sup, dim=1)
    ids = torch.cat([ids_sorted.to(torch.int32),
                     torch.zeros((n_chunks, 1), dtype=torch.int32,
                                 device=dev)], dim=1)
    ents = torch.cat([ents_sorted,
                      torch.full((n_chunks, 1), BIG, dtype=torch.float32,
                                 device=dev)], dim=1)

    # residual tile: only its last K_RES columns can hold huge prims; swept
    # densely with rays on the last axis
    colsK = ct.cols[C_reg]                               # (FEAT, OUTS*K)
    res_cols = torch.cat([colsK[:, k * K + K - K_RES:(k + 1) * K]
                          for k in range(OUTS)], dim=1)  # (FEAT, OUTS*K_RES)
    S_res = contract(phi, res_cols).T                    # (OUTS*K_RES, R)
    t_eff_res = _epilogue(
        S_res[0:K_RES], S_res[K_RES:2 * K_RES],
        S_res[2 * K_RES:3 * K_RES], S_res[3 * K_RES:4 * K_RES], a[None, :],
        ct.is_sphere[C_reg, 0, K - K_RES:, None] != 0,
        ct.valid_row[C_reg, 0, K - K_RES:, None] != 0, t_min, float(t_max))
    j_res = torch.argmin(t_eff_res, dim=0)
    t_res = torch.amin(t_eff_res, dim=0)
    b_res = torch.where(t_res < BIG * 0.5, C_reg * K + (K - K_RES) + j_res,
                        -1).to(torch.int32)

    C_tot = ct.cols.shape[0]
    args = (phi.contiguous(), a.contiguous(), gate.contiguous(),
            ids.contiguous(), ents.contiguous(), ct.cols,
            ct.is_sphere.view(C_tot, K), ct.ranges, K, t_min, float(t_max),
            ray_tile)
    return dict(o=o, d=d, active=active, active0=active0, rid=rid,
                extras=extras, args=args, t_res=t_res, b_res=b_res, r=r,
                cull2=cull2, sup=sup)


def cluster_march(ct: ClusterTables, o, d, t_min,
                  ray_tile: int = DEF_RAY_TILE, active=None, extras=None,
                  t_max: float = None, sort_rays: bool = True,
                  cull2: bool = None, sup: int = None):
    """Single-pass culled closest-hit: (prim_idx, t, valid), each (R,).

    Indices address ``ct.scene`` (the reordered scene). ``active`` ((R,)
    bool): lanes to query; inactive lanes resolve as misses. ``extras``
    (tuple of (R,) tensors, needs R % ray_tile == 0): the caller's per-ray
    state rides the binning sort and the result stays in sorted order;
    returns ``(idx, t, valid, o_s, d_s, active_s, extras_s, pair_tests)``,
    with ``pair_tests`` the executed (ray, prim-slot) tests, a 0-d int64
    tensor on the rays' device (counting waits for nothing). ``t_max``:
    hits at or beyond it are rejected and clusters entered beyond it are
    not marched. ``sort_rays`` False skips the binning sort (same result,
    less locality). ``cull2`` and ``sup``: the cull plan of
    :func:`march_inputs` (exact either way; winners may differ only at
    bit-equal t ties).

    The host's work before the launch, :func:`march_inputs`, is a
    ``pt.cull`` span (``utils/metrics.span``), inside the caller's
    ``pt.query``; on a plan that the preparation kernels do not take, its
    torch ops are a ``pt.cull2`` span inside it."""
    with metrics.span("pt.cull"):
        q = march_inputs(ct, o, d, t_min, ray_tile=ray_tile, active=active,
                         extras=extras, t_max=t_max, sort_rays=sort_rays,
                         cull2=cull2, sup=sup)
    t_best, best, slots = march(*q["args"])
    pair_tests = slots.sum() * (ct.K * ray_tile)

    # merge the residual (a cluster hit must beat it strictly)
    use_k = t_best < q["t_res"]
    t_best = torch.where(use_k, t_best, q["t_res"])
    best = torch.where(use_k, best, q["b_res"]).to(torch.int64)

    if extras is not None:
        # dead lanes can register pseudo-hits on enclosing residual spheres
        # (a is forced to 1); they are misses
        found = (best >= 0) & q["active"]
        idx = torch.where(found, best, 0)
        return (idx, t_best, found, q["o"], q["d"], q["active"], q["extras"],
                pair_tests)

    if sort_rays:
        rid = q["rid"]
        t_best = torch.empty_like(t_best).index_put_((rid,), t_best)
        best = torch.empty_like(best).index_put_((rid,), best)
    r = q["r"]
    t_best = t_best[:r]
    best = best[:r]
    found = (best >= 0) & q["active0"][:r]
    return torch.where(found, best, 0), t_best, found


def window_reference(phi, a, starts, skips, cols, is_sphere, ranges,
                     K: int, W: int, t_min: float, ray_tile: int):
    """Plain PyTorch twin of the CUDA window kernel: same inputs, same
    (t_best (R,) f32, best (R,) int32), ``best`` -1 where nothing is hit.

    Chunk i of ``ray_tile`` rays sweeps clusters starts[i] .. starts[i] +
    W - 1, each over its rows [lo, hi) = ranges[c] only, or gives (BIG, -1)
    where skips[i] is set. Loops over the window position j, vectorised
    over the chunks that are not skipped: the left-to-right contraction,
    the epilogue with each primitive typed by its own is_sphere row, hits
    in (t_min, BIG), the cluster's first minimum, and a strict-``<`` merge
    across clusters in ascending order. Raises ValueError where a swept
    chunk's window leaves the C_tot clusters or a range leaves [0, K]."""
    n_chunks = starts.shape[0]
    dev = phi.device
    C_tot = cols.shape[0]
    if bool(((skips == 0) & ((starts < 0) | (starts > C_tot - W))).any()):
        raise ValueError(f"a window [start, start + {W}) of a swept chunk "
                         f"leaves the {C_tot} clusters")
    check_ranges(ranges, K)
    P = phi.view(n_chunks, ray_tile, FEAT)
    A = a.view(n_chunks, ray_tile)
    t_acc = torch.full((n_chunks, ray_tile), BIG, dtype=torch.float32,
                       device=dev)
    b_acc = torch.full((n_chunks, ray_tile), -1, dtype=torch.int32,
                       device=dev)
    live = torch.nonzero(skips == 0).squeeze(1)
    if live.numel() > 0:
        P, A = P[live], A[live][:, :, None]
        start = starts[live].long()
        t_live, b_live = t_acc[live], b_acc[live]
        k = torch.arange(K, device=dev)
        for j in range(W):
            c = start + j
            rng = ranges[c]
            swept = ((k[None, :] >= rng[:, 0:1])
                     & (k[None, :] < rng[:, 1:2]))            # (L, K)
            S = contract(P, cols[c])                     # (L, T, OUTS*K)
            t_eff = _epilogue(S[..., 0:K], S[..., K:2 * K],
                              S[..., 2 * K:3 * K], S[..., 3 * K:4 * K], A,
                              is_sphere[c][:, None, :] != 0,
                              swept[:, None, :], t_min, BIG)
            local_j = torch.argmin(t_eff, dim=2)   # first minimum
            local_t = torch.amin(t_eff, dim=2)
            better = local_t < t_live
            glob = (c[:, None] * K + local_j).to(torch.int32)
            t_live = torch.where(better, local_t, t_live)
            b_live = torch.where(better, glob, b_live)
        t_acc[live] = t_live
        b_acc[live] = b_live
    return t_acc.reshape(-1), b_acc.reshape(-1)


def _window_cuda(phi, a, starts, skips, cols, is_sphere, ranges, K, W,
                 t_min, ray_tile):
    global WINDOW_LAUNCHES
    n_chunks = starts.shape[0]
    R = n_chunks * ray_tile
    C_tot = cols.shape[0]
    if ray_tile % 32 != 0 or not 0 < ray_tile <= 1024:
        raise ValueError("ray_tile must be a multiple of 32 up to 1024")
    if W < 1:
        raise ValueError(f"window width W must be positive, got {W}")
    for name, x, dtype, shape in (
            ("phi", phi, torch.float32, (R, FEAT)),
            ("a", a, torch.float32, (R,)),
            ("starts", starts, torch.int32, (n_chunks,)),
            ("skips", skips, torch.int32, (n_chunks,)),
            ("cols", cols, torch.float32, (C_tot, FEAT, OUTS * K)),
            ("is_sphere", is_sphere, torch.int32, (C_tot, K)),
            ("ranges", ranges, torch.int32, (C_tot, 2))):
        _cuda_build.check_arg(x, name, dtype, shape, phi.device)
    fn = _cuda_build.load("window_sweep",
                          _WINDOW_PROTOTYPES).window_sweep_launch
    t_out = torch.empty(R, dtype=torch.float32, device=phi.device)
    best = torch.empty(R, dtype=torch.int32, device=phi.device)
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    err = fn(phi.data_ptr(), a.data_ptr(), starts.data_ptr(),
             skips.data_ptr(), n_chunks, ray_tile, W, C_tot, cols.data_ptr(),
             is_sphere.data_ptr(), ranges.data_ptr(), K, t_min,
             t_out.data_ptr(), best.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"window_sweep kernel launch failed: CUDA error "
                           f"{err}")
    WINDOW_LAUNCHES += 1
    return t_out, best


def window_sweep(phi, a, starts, skips, cols, is_sphere, ranges, K: int,
                 W: int, t_min: float, ray_tile: int):
    """The window sweep: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors. phi (R, 12), a = |d|^2 (R,), starts / skips
    (R / ray_tile,) int32, cols (C_tot, 12, 4K), is_sphere (C_tot, K)
    int32, ranges (C_tot, 2) int32: the rows [lo, hi) of each
    cluster to sweep (``ClusterTables.ranges``). Returns (t_best (R,) f32,
    best (R,) int32), ``best`` the winner's c * K + k, -1 where nothing is
    hit.

    Every chunk that is not skipped needs 0 <= starts[i] and starts[i] + W
    <= C_tot, and every range must lie in [0, K]. The twin raises
    ValueError otherwise; the kernel fails a device-side assert, so PyTorch
    raises at the stream's next sync (the check costs no host sync per
    launch)."""
    if phi.device.type == "cuda":
        return _window_cuda(phi, a, starts, skips, cols, is_sphere, ranges,
                            K, W, t_min, ray_tile)
    if phi.device.type == "cpu":
        return window_reference(phi, a, starts, skips, cols, is_sphere,
                                ranges, K, W, t_min, ray_tile)
    raise ValueError(f"no window sweep for device {phi.device}")


def _key_and_resolved(entry, processed, t_best):
    """Per ray, the nearest unprocessed cluster whose entry can still beat
    its best hit (``argmin``'s first minimum), and whether none is left;
    resolved rays get ``_RESOLVED_KEY``."""
    cand = torch.where(processed | (entry >= t_best[:, None]), BIG, entry)
    m = torch.amin(cand, dim=1)
    key = torch.argmin(cand, dim=1)
    resolved = m >= BIG * 0.5
    return torch.where(resolved, _RESOLVED_KEY, key), resolved


def cluster_closest(ct: ClusterTables, o, d, t_min,
                    ray_tile: int = DEF_RAY_TILE, window: int = DEF_WINDOW,
                    max_rounds: int = DEF_MAX_ROUNDS,
                    sort_rays: bool = True):
    """The "rounds" culled closest-hit: (prim_idx, t, valid), each (R,).

    Indices address ``ct.scene``. Rays with d == 0 resolve as misses. Needs
    K % 128 == 0, as the reference does. Phases, in the reference's order:

    1. the residual tile, every ray once, in caller order (W = 1 from
       cluster C_reg; chunks whose rays are all dead are skipped);
    2. cull, then up to ``max_rounds`` rounds: a stable sort of the rays by
       round key (unless ``sort_rays`` is False), one window of W =
       min(window, C_reg) clusters per chunk starting at its smallest key,
       a strict-``<`` merge, the window marked processed, a re-cull and new
       keys;
    3. for rays still unresolved, one exact sweep of every regular cluster
       (W = C_reg from 0), unresolved rays first;
    4. back to caller order by ray id.

    The reference runs rounds in a ``lax.while_loop`` and the fallback
    under ``lax.cond``; here they are a Python loop and an ``if``, each
    with one host check of whether any ray is unresolved. The reference
    keeps the processed set as uint32 bitsets so it can ride ``lax.sort``;
    here it is an (R, C_reg) bool tensor permuted with the rays."""
    if ct.K % 128 != 0:
        raise ValueError("rounds strategy needs K % 128 == 0 (lane slices "
                         "at K granularity); small K is march+split only")
    r = o.shape[0]
    C_reg, K = ct.C_reg, ct.K
    C_tot = ct.cols.shape[0]
    W = min(window, C_reg)
    dev = o.device
    r_pad = -(-r // ray_tile) * ray_tile
    n_chunks = r_pad // ray_tile
    if r_pad != r:
        o = torch.cat([o, o.new_zeros((r_pad - r, 3))])
        d = torch.cat([d, d.new_zeros((r_pad - r, 3))])
    active = torch.any(d != 0.0, dim=1)
    active0 = active   # caller order
    t_min = float(t_min)
    tables = (ct.cols, ct.is_sphere.view(C_tot, K), ct.ranges)

    def window_pass(o_, d_, starts, skips, W_):
        phi = ray_features(o_, d_)
        a = vec.dot(d_, d_)
        # dead rays: a == 0 would NaN the sphere roots; a = 1 with d = 0
        # rejects them cleanly
        a = torch.where(a == 0.0, 1.0, a)
        return window_sweep(phi.contiguous(), a.contiguous(),
                            starts.to(torch.int32).contiguous(),
                            skips.to(torch.int32).contiguous(), *tables, K,
                            W_, t_min, ray_tile)

    # phase 1: the residual tile, every ray exactly once
    res_starts = torch.full((n_chunks,), C_reg, dtype=torch.int32,
                            device=dev)
    chunk_dead = torch.all(~active.view(n_chunks, ray_tile), dim=1)
    t_best, best = window_pass(o, d, res_starts, chunk_dead, 1)

    # phase 2: cull, then rounds
    entry = _cull(o, d, active, ct.cmin, ct.cmax, t_min)
    processed = torch.zeros((r_pad, C_reg), dtype=torch.bool, device=dev)
    key, resolved = _key_and_resolved(entry, processed, t_best)
    rid = torch.arange(r_pad, device=dev)
    clusters = torch.arange(C_reg, device=dev)
    rounds = 0
    while rounds < max_rounds and bool((~resolved).any()):
        if sort_rays:
            order = torch.sort(key, stable=True).indices
            key, o, d = key[order], o[order], d[order]
            t_best, best, rid = t_best[order], best[order], rid[order]
            processed = processed[order]
        chunk_min = torch.amin(key.view(n_chunks, ray_tile), dim=1)
        skip = chunk_min >= _RESOLVED_KEY
        starts = torch.clamp(chunk_min, 0, max(C_reg - W, 0))
        t_w, b_w = window_pass(o, d, starts, skip, W)
        better = t_w < t_best
        t_best = torch.where(better, t_w, t_best)
        best = torch.where(better, b_w, best)

        start_r = starts.repeat_interleave(ray_tile)[:, None]
        upd = (~skip).repeat_interleave(ray_tile)[:, None]
        processed = processed | (upd & (clusters[None, :] >= start_r)
                                 & (clusters[None, :] < start_r + W))
        entry = _cull(o, d, torch.any(d != 0.0, dim=1), ct.cmin, ct.cmax,
                      t_min)
        key, resolved = _key_and_resolved(entry, processed, t_best)
        rounds += 1

    # phase 3: the exact fallback for stragglers
    if bool((~resolved).any()):
        skey = resolved.to(torch.int32)
        if sort_rays:
            # compact the unresolved rays into the leading chunks
            order = torch.sort(skey, stable=True).indices
            skey, o, d = skey[order], o[order], d[order]
            t_best, best, rid = t_best[order], best[order], rid[order]
        skip = torch.all(skey.view(n_chunks, ray_tile) == 1, dim=1)
        t_w, b_w = window_pass(o, d, torch.zeros_like(skip, dtype=torch.int32),
                               skip, C_reg)
        better = t_w < t_best
        t_best = torch.where(better, t_w, t_best)
        best = torch.where(better, b_w, best)

    # back to caller order (unsorted mode never permutes)
    if sort_rays:
        t_best = torch.empty_like(t_best).index_put_((rid,), t_best)
        best = torch.empty_like(best).index_put_((rid,), best)
    t_best = t_best[:r]
    best = best[:r].to(torch.int64)
    # dead lanes can register pseudo-hits on enclosing residual spheres
    # (a is forced to 1); they are misses
    found = (best >= 0) & active0[:r]
    return torch.where(found, best, 0), t_best, found


def make_cluster_closest_hit(ct: ClusterTables, t_min: float,
                             ray_tile: int = DEF_RAY_TILE,
                             window: int = DEF_WINDOW,
                             max_rounds: int = DEF_MAX_ROUNDS,
                             sort_rays: bool = True,
                             strategy: str = "march", cull2: bool = None,
                             sup: int = None,
                             cull2_clusters: int = CULL2_CLUSTERS):
    """Closest-hit factory over prebuilt cluster tables. ``closest(o, d)``
    returns (idx, t, valid) in caller order; ``closest.query_shadow(o, d,
    active)`` is the NEE occlusion query. Indices refer to ``ct.scene``.

    ``PT_CLUSTER_RAYTILE``, where set, overrides ``ray_tile``, as it does
    in the reference's factory.

    ``strategy`` "march" (:func:`cluster_march`) also gives
    ``closest.query_sorted(o, d, active, extras)``, the sorted-wavefront
    protocol, when ``sort_rays``; its cull plan (``cull2``, ``sup``,
    ``cull2_clusters``: :func:`cull_plan` of ``ct.C_reg``) is
    ``closest.cull_plan`` and its tables ``closest.tables``. "rounds" (:func:`cluster_closest`, where
    ``window`` and ``max_rounds`` apply) has no sorted protocol, so the
    integrator queries it in caller order; it needs K % 128 == 0."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown cluster strategy {strategy!r}; "
                         f"available: {', '.join(STRATEGIES)}")
    if strategy == "rounds" and ct.K % 128 != 0:
        raise ValueError(f"rounds strategy needs K % 128 == 0, got K = "
                         f"{ct.K}")
    ray_tile = int(os.environ.get("PT_CLUSTER_RAYTILE") or ray_tile)
    closest_kw = dict(ray_tile=ray_tile, sort_rays=sort_rays)

    if strategy == "rounds":
        closest_kw.update(window=window, max_rounds=max_rounds)

        def closest(o, d):
            return cluster_closest(ct, o, d, float(t_min), **closest_kw)

        def query_shadow(o, d, active=None):
            # the reference's rounds shadow query: near-zero t_min, no t_max
            # (the caller zeroes inactive segments, which resolve as misses)
            return cluster_closest(ct, o, d, K_SHADOW_T_MIN, **closest_kw)
    else:
        cull2, sup = cull_plan(ct.C_reg, cull2, sup, cull2_clusters)
        closest_kw.update(cull2=cull2, sup=sup)

        def closest(o, d):
            return cluster_march(ct, o, d, float(t_min), **closest_kw)

        def query_shadow(o, d, active=None):
            # the segment runs to the light point at t == 1: t_max = 1
            # rejects geometry beyond the light and stops the march there.
            # Its origin is already offset off the surface (render/lights),
            # so t_min is the near-zero K_SHADOW_T_MIN, not the bounce t_min
            global MARCH_SHADOW_LAUNCHES
            MARCH_SHADOW_LAUNCHES += 1
            return cluster_march(ct, o, d, K_SHADOW_T_MIN, ray_tile=ray_tile,
                                 active=active, t_max=1.0, sort_rays=False,
                                 cull2=cull2, sup=sup)

        if sort_rays:
            def query_sorted(o, d, active, extras):
                return cluster_march(ct, o, d, float(t_min),
                                     ray_tile=ray_tile, active=active,
                                     extras=extras, cull2=cull2, sup=sup)
            closest.query_sorted = query_sorted
            closest.ray_tile = ray_tile
        closest.cull_plan = (cull2, sup)
        closest.tables = ct

    closest.handles_dead = True
    closest.query_shadow = query_shadow
    return closest
