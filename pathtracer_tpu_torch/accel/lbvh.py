"""Karras LBVH built with tensor ops on the scene's device
(``accel/lbvh.py``).

Morton codes, a stable sort, the range and split searches of every
internal node at once, level-synchronised bottom-up box sweeps and the
threaded escape links of stackless traversal, as in the reference. The
build is integer and min/max arithmetic only, so its arrays are bit-equal
to the reference's for the same scene. The searches and sweeps are
fixed-count loops of tensor ops, with no host sync inside.

Node layout: internal nodes at [0, n-2], leaves at [n-1, 2n-2]; a node is
a leaf iff its ``obj_id`` is not -1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_tpu_torch.ops import morton
from pathtracer_tpu_torch.scene.scene import Scene

# A Karras tree over 64-bit keys (32-bit code, 32-bit id tie-break) has
# common-prefix lengths strictly increasing along any root-to-leaf path,
# so its depth is at most 65: the sweeps below cover that.
MAX_DEPTH_SWEEPS = 66
SEARCH_BITS = 32  # the range and split searches cover n up to 2^32
_BIG = 3e38


class LBVH(NamedTuple):
    """Node arrays of length 2n-1 (ints int32)."""
    box_min: torch.Tensor   # (2n-1, 3)
    box_max: torch.Tensor   # (2n-1, 3)
    left: torch.Tensor      # (2n-1,) -1 for leaves
    right: torch.Tensor     # (2n-1,) -1 for leaves
    parent: torch.Tensor    # (2n-1,) -1 for the root
    obj_id: torch.Tensor    # (2n-1,) primitive of a leaf, else -1
    escape: torch.Tensor    # (2n-1,) threaded miss link; 2n-1 = done

    @property
    def num_nodes(self) -> int:
        return self.box_min.shape[0]

    @property
    def num_leaves(self) -> int:
        return (self.num_nodes + 1) // 2


def build_lbvh(scene: Scene) -> LBVH:
    """The LBVH of ``scene``'s primitive boxes, on the scene's device."""
    n = scene.num_prims
    dev = scene.device
    box_lo = scene.box_min.detach()
    box_hi = scene.box_max.detach()
    centers = 0.5 * (box_lo + box_hi)
    codes = morton.morton3d(centers, scene.world_min.detach(),
                            scene.world_max.detach())
    # stable: equal codes keep ids ascending, the reference's tie-break
    codes_s, ids_s = torch.sort(codes, stable=True)

    def delta(i, j):
        """Common-prefix length of sorted keys i and j; -1 off the
        range."""
        valid = (j >= 0) & (j < n) & (i >= 0) & (i < n)
        ic = i.clamp(0, n - 1)
        jc = j.clamp(0, n - 1)
        d = morton.clz64_pair(codes_s[ic], ids_s[ic], codes_s[jc],
                              ids_s[jc])
        return torch.where(valid, d, -1)

    num_internal = max(n - 1, 1)  # n == 1: one masked node
    i_arr = torch.arange(num_internal, dtype=torch.int64, device=dev)

    # determineRange: the direction, then an exponential search and a
    # binary descent for the range's length
    d_left = delta(i_arr, i_arr - 1)
    d_right = delta(i_arr, i_arr + 1)
    direction = torch.sign(d_right - d_left)
    min_delta = torch.minimum(d_left, d_right)
    stride = torch.full_like(i_arr, 2)
    for _ in range(SEARCH_BITS):
        stride = torch.where(delta(i_arr, i_arr + stride * direction)
                             > min_delta, stride * 2, stride)
    length = torch.zeros_like(i_arr)
    cur = stride >> 1
    for _ in range(SEARCH_BITS):
        step = (cur >= 1) & (delta(i_arr, i_arr + (length + cur) * direction)
                             > min_delta)
        length = torch.where(step, length + cur, length)
        cur = cur >> 1
    j_arr = i_arr + length * direction
    first = torch.minimum(i_arr, j_arr)
    last = torch.maximum(i_arr, j_arr)

    # findSplit: binary search for the highest differing bit
    common_prefix = delta(first, last)
    split = first
    step = last - first
    done = first == last
    for _ in range(SEARCH_BITS):
        step = (step + 1) >> 1
        new_split = split + step
        ok = (new_split < last) & (delta(first, new_split) > common_prefix)
        split = torch.where(~done & ok, new_split, split)
        done = done | (step <= 1)
    split = torch.where(first == last, (first + last) >> 1, split)

    # a child is a leaf iff it sits at the edge of its node's range
    leaf_start = n - 1
    child_a = torch.where(split == first, leaf_start + split, split)
    child_b = torch.where(split + 1 == last, leaf_start + split + 1,
                          split + 1)

    num_nodes = 2 * n - 1
    left = torch.full((num_nodes,), -1, dtype=torch.int64, device=dev)
    right = left.clone()
    parent = left.clone()
    obj_id = left.clone()
    leaves = leaf_start + torch.arange(n, dtype=torch.int64, device=dev)
    obj_id[leaves] = ids_s
    box_min = torch.full((num_nodes, 3), _BIG, dtype=torch.float32,
                         device=dev)
    box_max = torch.full((num_nodes, 3), -_BIG, dtype=torch.float32,
                         device=dev)
    box_min[leaves] = box_lo[ids_s]
    box_max[leaves] = box_hi[ids_s]
    if n > 1:
        left[:num_internal] = child_a
        right[:num_internal] = child_b
        parent[child_a] = i_arr
        parent[child_b] = i_arr
        # bottom-up boxes: each sweep reads the previous sweep's boxes
        for _ in range(MAX_DEPTH_SWEEPS):
            new_min = torch.minimum(box_min[child_a], box_min[child_b])
            new_max = torch.maximum(box_max[child_a], box_max[child_b])
            box_min[:num_internal] = new_min
            box_max[:num_internal] = new_max

    # escape(x) = the right sibling of x's lowest ancestor-or-self that is
    # a left child; none -> the done sentinel (num_nodes)
    y = torch.arange(num_nodes, dtype=torch.int64, device=dev)
    escape = torch.full_like(y, num_nodes)
    resolved = torch.zeros(num_nodes, dtype=torch.bool, device=dev)
    for _ in range(MAX_DEPTH_SWEEPS):
        p = parent[y.clamp(0, num_nodes - 1)]
        at_root = p < 0
        pc = p.clamp(0, num_nodes - 1)
        is_left = ~at_root & (left[pc] == y)
        escape = torch.where(~resolved & is_left, right[pc], escape)
        resolved = resolved | at_root | is_left
        y = torch.where(resolved, y, p)

    def i32(x):
        return x.to(torch.int32)
    return LBVH(box_min=box_min, box_max=box_max, left=i32(left),
                right=i32(right), parent=i32(parent), obj_id=i32(obj_id),
                escape=i32(escape))
