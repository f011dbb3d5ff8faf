"""Stackless (threaded) BVH traversal over a ray wavefront
(``ops/traversal.py``).

Each ray carries one node pointer: at an internal node a box hit descends
to the left child and a miss follows the node's ``escape`` link; a leaf
tests its primitive and follows its escape. The state per ray is (pointer,
best t, best primitive). One fused node table holds each node's box, its
leaf's geometry and its links, so a step gathers one row per table. The
done sentinel indexes a dummy row whose inverted box never hits and whose
escape is itself, so a finished ray idles without a mask.

The reference leaves this loop to XLA (no Pallas kernel), and the port
runs it as plain tensor ops. Its ``while any(pointer != done)`` would be a
host sync per step; the port tests it every :data:`CHECK_EVERY` steps,
capped at ``max_steps``, which changes no result (the extra steps of a
finished ray are exact no-ops).

The query returns winner indices only (visibility); the hit geometry is
re-evaluated outside (``ops/intersect.hit_records_from_prims``), and the
node table is built from the detached scene, so visibility is detached.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pathtracer_tpu_torch.accel.lbvh import LBVH
from pathtracer_tpu_torch.ops import intersect
from pathtracer_tpu_torch.scene.scene import Scene

CHECK_EVERY = 16   # traversal steps between host checks for all-done


class FatNodes(NamedTuple):
    """Fused traversal table of 2n rows, the last the done dummy."""
    fdata: torch.Tensor  # (2n, 16) f32: bmin, bmax, v0, e1, e2, radius
    idata: torch.Tensor  # (2n, 4) int64: left, escape, prim type (0 =
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
                        dim=1).long()
    done = num_nodes
    dummy_f = torch.cat([torch.full((1, 3), 3e38), torch.full((1, 3), -3e38),
                         torch.zeros((1, 9)), torch.ones((1, 1))],
                        dim=1).to(dev)
    dummy_i = torch.tensor([[done, done, 0, 0]], dtype=torch.int64,
                           device=dev)
    return FatNodes(fdata=torch.cat([fdata, dummy_f]),
                    idata=torch.cat([idata, dummy_i]), done=done)


def traverse(nodes: FatNodes, o, d, t_min, t_max, max_steps: int = 0):
    """Closest hit of each ray: (prim_idx (R,) int64, t (R,), valid (R,)
    bool), t = ``t_max`` on a miss. ``max_steps`` bounds the loop (default
    4 times the rows: a guard against a malformed tree; a depth-first walk
    visits each node at most once a ray)."""
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
            irow = nodes.idata[ptr]
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
