"""Stackless (threaded) BVH traversal over a ray wavefront
(``ops/traversal.py``).

Each ray carries one node pointer: at an internal node a box hit descends
to the left child and a miss follows the node's ``escape`` link; a leaf
tests its primitive and follows its escape. The state per ray is (pointer,
best t, best primitive). One fused node table holds each node's box, its
leaf's geometry and its links, so a step gathers one row per table. The
done sentinel indexes a dummy row whose inverted box never hits and whose
escape is itself, so a finished ray idles without a mask.

The reference runs this loop as one ``lax.while_loop`` on the device (no
Pallas kernel). :func:`traverse` picks by device only: a CUDA tensor
launches the hand-written kernel ``csrc/bvh_traverse.cu`` (one thread a
ray, each walking to the done row or the step cap; one launch a query, no
host sync) or raises, and a CPU tensor takes the plain twin
:func:`traverse_reference`, the same loop as tensor ops over the whole
wavefront. The twin tests its ``while any(pointer != done)`` every
:data:`CHECK_EVERY` steps, capped at ``max_steps``, which changes no result
(the extra steps of a finished ray are exact no-ops), so kernel and twin
agree to the bit.

The query returns winner indices only (visibility); the hit geometry is
re-evaluated outside (``ops/intersect.hit_records_from_prims``), and the
node table is built from the detached scene, so visibility is detached.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from pathtracer_tpu_torch.accel.lbvh import LBVH
from pathtracer_tpu_torch.ops import _cuda_build, intersect
from pathtracer_tpu_torch.scene.scene import Scene

CHECK_EVERY = 16   # the twin's traversal steps between all-done checks

# Launches of the traversal kernel in this process (the wrapper adds one per
# launch and nowhere else); callers reset it to 0 to count a run.
TRAVERSE_LAUNCHES = 0

_PROTOTYPES = {"bvh_traverse_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p]}


class FatNodes(NamedTuple):
    """Fused traversal table of 2n rows, the last the done dummy."""
    fdata: torch.Tensor  # (2n, 16) f32: bmin, bmax, v0, e1, e2, radius
    idata: torch.Tensor  # (2n, 4) int32: left, escape, prim type (0 =
    #                      internal), prim id
    done: int            # the sentinel row (2n - 1)


def pack_fat_nodes(scene: Scene, bvh: LBVH) -> FatNodes:
    """Gather each leaf's primitive geometry into the node table (from the
    detached scene)."""
    num_nodes = bvh.num_nodes
    dev = bvh.box_min.device
    is_leaf = bvh.obj_id >= 0
    pid = bvh.obj_id.clamp(0, scene.num_prims - 1).long()
    ptype = torch.where(is_leaf, scene.prim_type[pid], 0)
    fdata = torch.cat([bvh.box_min, bvh.box_max, scene.v0[pid].detach(),
                       scene.e1[pid].detach(), scene.e2[pid].detach(),
                       scene.radius[pid].detach()[:, None]], dim=1)
    idata = torch.stack([bvh.left, bvh.escape, ptype,
                         torch.where(is_leaf, bvh.obj_id, 0)],
                        dim=1).to(torch.int32)
    done = num_nodes
    dummy_f = torch.cat([torch.full((1, 3), 3e38), torch.full((1, 3), -3e38),
                         torch.zeros((1, 9)), torch.ones((1, 1))],
                        dim=1).to(dev)
    dummy_i = torch.tensor([[done, done, 0, 0]], dtype=torch.int32,
                           device=dev)
    return FatNodes(fdata=torch.cat([fdata, dummy_f]),
                    idata=torch.cat([idata, dummy_i]), done=done)


def traverse_reference(nodes: FatNodes, o, d, t_min, t_max,
                       max_steps: int = 0):
    """The plain twin of the traversal kernel: the loop over the whole
    wavefront as tensor ops, with an all-done check every
    :data:`CHECK_EVERY` steps. Arguments and results as :func:`traverse`."""
    done = nodes.done
    if max_steps <= 0:
        max_steps = 4 * nodes.fdata.shape[0]
    r = o.shape[0]
    dev = o.device
    ptr = torch.zeros(r, dtype=torch.int64, device=dev)
    t_best = torch.full((r,), t_max, dtype=torch.float32, device=dev)
    best = torch.full((r,), -1, dtype=torch.int64, device=dev)
    steps = 0
    while steps < max_steps:
        for _ in range(min(CHECK_EVERY, max_steps - steps)):
            frow = nodes.fdata[ptr]
            irow = nodes.idata[ptr].long()
            box_hit = intersect.ray_aabb_hit(o, d, frow[:, 0:3],
                                             frow[:, 3:6], t_min, t_best)
            is_leaf = irow[:, 2] > 0
            hit, t = intersect.intersect_prims(
                o, d, irow[:, 2], frow[:, 6:9], frow[:, 9:12],
                frow[:, 12:15], frow[:, 15], t_min, t_best)
            better = box_hit & is_leaf & hit & (t < t_best)
            t_best = torch.where(better, t, t_best)
            best = torch.where(better, irow[:, 3], best)
            ptr = torch.where(box_hit & ~is_leaf, irow[:, 0], irow[:, 1])
            steps += 1
        if not bool((ptr != done).any()):
            break
    valid = best >= 0
    return torch.where(valid, best, 0), t_best, valid


def _traverse_cuda(nodes: FatNodes, o, d, t_min, t_max, max_steps: int):
    """One launch of ``csrc/bvh_traverse.cu`` on the current stream."""
    global TRAVERSE_LAUNCHES
    dev = o.device
    r = o.shape[0]
    rows = nodes.fdata.shape[0]
    if max_steps <= 0:
        max_steps = 4 * rows
    o, d = o.contiguous(), d.contiguous()
    for name, x, dtype, shape in (
            ("o", o, torch.float32, (r, 3)),
            ("d", d, torch.float32, (r, 3)),
            ("fdata", nodes.fdata, torch.float32, (rows, 16)),
            ("idata", nodes.idata, torch.int32, (rows, 4))):
        _cuda_build.check_arg(x, name, dtype, shape, dev)
    idx = torch.empty(r, dtype=torch.int64, device=dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    valid = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:
        return idx, t, valid
    fn = _cuda_build.load("bvh_traverse", _PROTOTYPES).bvh_traverse_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(o.data_ptr(), d.data_ptr(), r, nodes.fdata.data_ptr(),
             nodes.idata.data_ptr(), rows, nodes.done, max_steps,
             float(t_min), float(t_max), idx.data_ptr(), t.data_ptr(),
             valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse kernel launch failed: CUDA error "
                           f"{err}")
    TRAVERSE_LAUNCHES += 1
    return idx, t, valid


def traverse(nodes: FatNodes, o, d, t_min, t_max, max_steps: int = 0):
    """Closest hit of each ray: (prim_idx (R,) int64, t (R,), valid (R,)
    bool), t = ``t_max`` on a miss. ``max_steps`` bounds each ray's walk
    (default 4 times the rows: a guard against a malformed tree; a
    depth-first walk visits each node at most once a ray). The kernel for
    CUDA tensors (one launch), the plain twin for CPU tensors; both compare
    with ``t_min`` and ``t_max`` as float32."""
    if o.device.type == "cuda":
        return _traverse_cuda(nodes, o, d, t_min, t_max, max_steps)
    if o.device.type == "cpu":
        return traverse_reference(nodes, o, d, t_min, t_max, max_steps)
    raise ValueError(f"no BVH traversal for device {o.device}")


def make_bvh_closest_hit(scene: Scene, bvh: LBVH, t_min: float,
                         nodes: Optional[FatNodes] = None):
    """Closest-hit query ``closest(o, d) -> (idx, t, valid)`` for hits in
    (t_min, BIG_T), over a node table packed from the detached scene, or
    over ``nodes``, that table already packed (queries at two t_min share
    one)."""
    if nodes is None:
        nodes = pack_fat_nodes(scene, bvh)

    def closest(o, d):
        return traverse(nodes, o, d, t_min, intersect.BIG_T)
    return closest
