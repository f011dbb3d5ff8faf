"""Morton clustering of primitives for the culled closest-hit
(``ops/clusters.py``).

Primitives are sorted by the morton code of their AABB center and grouped
into clusters of K consecutive rows, each with a cluster AABB. Huge
primitives (backdrop spheres) go to a residual tile, the last K rows of the
reordered table, which every ray sweeps once per query; at most K_RES of
them, sorted to the very end of that tile. The morton domain covers the
regular primitives only.

The reference also stores a bf16 three-way split of each primitive's hit
fields for in-kernel winner extraction on the TPU; the port gathers winner
rows by index instead (``ops/intersect.hit_records_from_prims``).
"""
from __future__ import annotations

import dataclasses

import torch

from pathtracer_tpu_torch.ops import morton
from pathtracer_tpu_torch.ops.tensor_sweep import (pack_sweep_tables,
                                                   row_ranges)
from pathtracer_tpu_torch.scene.scene import PRIM_SPHERE, Scene

# Sort-key bands: regular prims carry their 30-bit morton code, padding
# rows sort after every regular prim, huge prims last (residual tile).
_KEY_PAD = 0x40000000
_KEY_HUGE = 0x80000000

HUGE_EXTENT_FACTOR = 16.0
K_RES = 8


@dataclasses.dataclass(frozen=True)
class ClusterTables:
    """Reordered scene + per-cluster sweep tables.

    Rows [0, C_reg*K) of ``scene`` are regular prims in morton order, K per
    cluster; rows [C_reg*K, (C_reg+1)*K) are the residual tile. Row c of
    ``cols``/``is_sphere``/``valid_row`` is cluster c (row C_reg the
    residual tile)."""
    scene: Scene
    cols: torch.Tensor       # (C_reg+1, FEAT, OUTS*K) f32
    is_sphere: torch.Tensor  # (C_reg+1, 1, K) int32
    valid_row: torch.Tensor  # (C_reg+1, 1, K) int32
    cmin: torch.Tensor       # (C_reg, 3) regular-cluster AABB corners
    cmax: torch.Tensor       # (C_reg, 3)
    ctype: torch.Tensor      # (C_reg+1,) int32: 0 mixed, 1 all-sphere,
                             # 2 all-triangle (among valid rows)
    perm: torch.Tensor       # (total,) int64: original row per new row
    K: int
    C_reg: int
    # (C_reg+1, 2) int32: the rows [lo, hi) of each cluster that hold a
    # primitive of the scene (the march and the window sweep sweep only
    # these; the
    # padding rows, which ``valid_row`` marks valid as the reference's
    # tables do, can never be hit). Regular clusters [0, n), the residual
    # tile [K - n_huge, K), an empty cluster [0, 0).
    ranges: torch.Tensor


def _pad_prim_rows(scene: Scene, total: int) -> dict:
    """Extend the per-primitive columns to ``total`` rows with inert
    padding (degenerate far-away spheres, inverted AABBs)."""
    pad = total - scene.num_prims
    big = 3e37

    def ext(x, value):
        return torch.cat([x, x.new_full((pad,) + x.shape[1:], value)])

    return dict(
        prim_type=ext(scene.prim_type, PRIM_SPHERE),
        v0=ext(scene.v0, big), e1=ext(scene.e1, 0.0), e2=ext(scene.e2, 0.0),
        radius=ext(scene.radius, 0.0), tri_normal=ext(scene.tri_normal, 0.0),
        prim_mat=ext(scene.prim_mat, 0),
        box_min=ext(scene.box_min, big), box_max=ext(scene.box_max, -big))


def _median_midpoint(x):
    """Median of a 1-D float32 tensor as the mean of the two middle values
    ((lo + hi) * 0.5, the reference's midpoint rule); 0 when empty."""
    n = x.shape[0]
    if n == 0:
        return x.new_zeros(())
    s = torch.sort(x).values
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def build_cluster_tables(scene: Scene, K: int = 128) -> ClusterTables:
    """Cluster the scene's primitives on the scene's device. The tables are
    built from detached rows, so no kernel input carries autograd history;
    the reordered ``scene`` is the caller's rows gathered by ``perm`` (the
    padding rows constants), so gradients of what is shaded with it reach
    the caller's tensors."""
    if K % 8 != 0 or K < K_RES:
        raise ValueError("cluster size K must be a multiple of 8, >= K_RES")
    dev = scene.device
    n0 = scene.num_prims
    C_reg = max(1, -(-n0 // K))
    total = (C_reg + 1) * K

    rows = _pad_prim_rows(scene, total)
    box_min, box_max = rows["box_min"].detach(), rows["box_max"].detach()

    # classify: padding rows have inverted boxes (negative extent)
    extent = torch.amax(box_max - box_min, dim=-1)
    is_real = extent >= 0.0
    med = _median_midpoint(extent[is_real])
    huge = is_real & (extent > torch.clamp(HUGE_EXTENT_FACTOR * med,
                                           min=1e-6))
    # keep only the K_RES largest: the skinny residual sweep tests the last
    # K_RES reordered rows
    hkey = torch.where(huge, -extent, 3e38)
    by_size = torch.sort(hkey, stable=True).indices
    rank = torch.empty_like(by_size)
    rank[by_size] = torch.arange(total, device=dev)
    huge = huge & (rank < K_RES)

    # morton domain over the regular (non-huge, real) prims only
    reg = (is_real & ~huge)[:, None]
    dmin = torch.amin(torch.where(reg, box_min, 3e38), dim=0)
    dmax = torch.amax(torch.where(reg, box_max, -3e38), dim=0)
    center = 0.5 * (box_min + box_max)
    code = morton.morton3d(center, dmin, dmax)
    key = torch.where(~is_real, _KEY_PAD,
                      torch.where(huge, _KEY_HUGE | code, code))

    perm = torch.sort(key, stable=True).indices

    # remap the light list to the new row positions
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(total, device=dev)
    light_idx = scene.light_idx
    if scene.num_lights > 0:
        light_idx = torch.sort(inv[light_idx.long()]).values.to(torch.int32)

    new_scene = scene._replace(light_idx=light_idx,
                               **{nm: x[perm] for nm, x in rows.items()})
    packed = Scene(*(x.detach() for x in new_scene))
    tables = pack_sweep_tables(packed, tile=K)
    assert tables.tile == K and tables.cols.shape[0] == C_reg + 1

    cmin = packed.box_min[:C_reg * K].reshape(C_reg, K, 3).amin(dim=1)
    cmax = packed.box_max[:C_reg * K].reshape(C_reg, K, 3).amax(dim=1)

    any_s = (tables.is_sphere & tables.valid_row).any(dim=1)
    any_t = (~tables.is_sphere & tables.valid_row).any(dim=1)
    ctype = torch.where(any_s & any_t, 0,
                        torch.where(any_s, 1, 2)).to(torch.int32)

    # the sort key puts padding after the regular prims and before the huge
    # ones, so each cluster's real rows are contiguous (row_ranges checks)
    ranges = row_ranges((perm < n0).view(C_reg + 1, K))

    return ClusterTables(
        scene=new_scene, cols=tables.cols,
        is_sphere=tables.is_sphere.to(torch.int32)[:, None, :].contiguous(),
        valid_row=tables.valid_row.to(torch.int32)[:, None, :].contiguous(),
        cmin=cmin, cmax=cmax, ctype=ctype, perm=perm, K=K, C_reg=C_reg,
        ranges=ranges)
