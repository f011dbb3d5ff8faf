"""Top-level renderer: pixel grid -> rays -> integrator -> gamma'd image
(``render/renderer.py``).

The image is flattened to a ray wavefront and traced in chunks of
``cfg.ray_chunk`` rays; samples accumulate into a framebuffer; the
writeback is gamma 2, ``sqrt(sum / spp)``. Pixel conventions follow the
reference: u = (col + xi) / W, v = (row + xi) / H with row 0 at the bottom.

The random key chain is the reference's, bit for bit: ``fold_in(base,
sample)``, ``fold_in(·, first pixel of the chunk)``, ``split(·, 4)`` into
(pixel jitter, trace, lens, time) keys, and per bounce ``fold_in(trace key,
depth)`` keyed again by ray id (``core/random``).

Only the slice's path is ported: the cluster march (``accel`` "cluster",
or "auto" on scenes of K_AUTO_ACCEL_PRIMS prims or more), uniform pixel
jitter, no NEE or Russian roulette, no textures, forward only. Everything
else raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch

from pathtracer_tpu_torch import config as config_mod
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.core import camera as camera_mod
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.ops.cluster_sweep import make_cluster_closest_hit
from pathtracer_tpu_torch.ops.clusters import ClusterTables, \
    build_cluster_tables
from pathtracer_tpu_torch.render import integrator
from pathtracer_tpu_torch.scene.scene import Scene

# Cluster size. The reference picks 64 unless its tables would overflow TPU
# VMEM; the port has no such limit. Re-choosing K for the H100 is ROADMAP
# Queue 1, item 9.
CLUSTER_K = 64


def check_supported(cfg: RenderConfig, scene: Scene) -> None:
    """Raise NotImplementedError for anything off the ported slice."""
    accel = config_mod.resolve_accel(cfg.accel, scene.num_prims)
    if accel != "cluster":
        item = {"tensor": 7, "pallas": 7, "brute": 7, "bvh": 12}[accel]
        raise NotImplementedError(
            f"accel {accel!r} is not ported yet (ROADMAP Queue 1, item "
            f"{item}); use accel='cluster'")
    if cfg.nee or cfg.rr or cfg.stratify or cfg.sampler != "random":
        raise NotImplementedError(
            "NEE, Russian roulette, stratified and Sobol sampling are not "
            "ported yet (ROADMAP Queue 1, item 8)")
    if scene.textures.shape[0] > 0:
        raise NotImplementedError(
            "image textures are not ported yet (ROADMAP Queue 1, item 8)")


def _pixel_grid(width: int, height: int, n_padded: int, device):
    """Flat float32 (row, col) grids, row-major, zero-padded to
    ``n_padded``."""
    rows = torch.arange(height, dtype=torch.float32,
                        device=device).repeat_interleave(width)
    cols = torch.arange(width, dtype=torch.float32,
                        device=device).repeat(height)
    pad = n_padded - rows.shape[0]
    return (torch.cat([rows, rows.new_zeros(pad)]),
            torch.cat([cols, cols.new_zeros(pad)]))


def render_sum(scene: Scene, cam: camera_mod.Camera, base_key, rows, cols,
               cfg: RenderConfig, spp: int, ct: ClusterTables,
               differentiable: bool = False):
    """Radiance SUM (P, 3) over ``spp`` samples for a flat pixel wavefront
    (P a multiple of the chunk), not averaged or gamma'd, and the executed
    (closest-hit queries, march pair tests).

    ``ct`` holds the cluster tables of ``scene``; shading uses its
    reordered scene. Chunk keys derive from the first pixel's global index,
    so a pixel's samples do not depend on the chunking."""
    if differentiable:
        raise NotImplementedError(
            "the differentiable render is not ported yet (ROADMAP Queue 1, "
            "item 10)")
    check_supported(cfg, scene)
    n_padded = rows.shape[0]
    chunk = min(cfg.ray_chunk, n_padded)
    n_chunks = n_padded // chunk
    if n_chunks * chunk != n_padded:
        raise ValueError("wavefront must be chunk-aligned")
    w_inv = 1.0 / cfg.width
    h_inv = 1.0 / cfg.height
    dev = rows.device
    closest = make_cluster_closest_hit(ct, cfg.t_min)
    shade_scene = ct.scene

    acc = torch.zeros((n_padded, 3), dtype=torch.float32, device=dev)
    n_queries = n_pairs = 0.0
    for s in range(spp):
        skey = prng.fold_in(base_key, s)
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            row, col = rows[sl], cols[sl]
            ckey = prng.fold_in(skey, c * chunk)
            pkey, tkey, lkey1, lkey2 = prng.split(ckey, 4)
            xi = prng.uniform(pkey, (2, chunk), dev)
            u = (col + xi[0]) * w_inv
            v = (row + xi[1]) * h_inv
            u_disk = prng.uniform(lkey1, (2, chunk), dev)
            u_time = prng.uniform(lkey2, (chunk,), dev)
            # shutter time is unused: no ported scene moves
            o, d, _ = camera_mod.get_rays(cam, u, v, u_disk[0], u_disk[1],
                                          u_time)
            radiance, (nq, npairs) = integrator.trace(
                shade_scene, o, d, tkey, cfg.max_depth, closest,
                t_min=cfg.t_min, sky=cfg.sky,
                terminate_black=cfg.terminate_black)
            acc[sl] += radiance
            n_queries += nq
            n_pairs += npairs
    return acc, (n_queries, n_pairs)


class Renderer:
    """``render(scene, cam, seed) -> (H, W, 3)`` for one config on one
    device; cluster tables are built once per scene and cached."""

    def __init__(self, cfg: RenderConfig, device, with_stats: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.with_stats = with_stats
        self._tables: dict = {}   # id(scene) -> (scene, ClusterTables)
        # full float32 everywhere: TF32 would round the sweep's operands
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def tables(self, scene: Scene) -> ClusterTables:
        hit = self._tables.get(id(scene))
        if hit is not None and hit[0] is scene:
            return hit[1]
        ct = build_cluster_tables(scene.to(self.device), K=CLUSTER_K)
        self._tables = {id(scene): (scene, ct)}
        return ct

    def __call__(self, scene: Scene, cam: camera_mod.Camera,
                 seed: Optional[int] = None):
        cfg = self.cfg
        check_supported(cfg, scene)
        n_pixels = cfg.num_pixels
        chunk = min(cfg.ray_chunk, n_pixels)
        n_padded = -(-n_pixels // chunk) * chunk
        rows, cols = _pixel_grid(cfg.width, cfg.height, n_padded,
                                 self.device)
        base_key = prng.PRNGKey(cfg.seed if seed is None else seed)
        acc, stats = render_sum(scene, cam.to(self.device), base_key, rows,
                                cols, cfg, cfg.spp, self.tables(scene))
        img = torch.sqrt(torch.clamp(acc[:n_pixels], min=0.0) / cfg.spp)
        img = img.reshape(cfg.height, cfg.width, 3)
        return (img, stats) if self.with_stats else img


def make_renderer(cfg: RenderConfig, device, with_stats: bool = False):
    """A :class:`Renderer` for ``cfg`` on ``device``."""
    return Renderer(cfg, device, with_stats=with_stats)


def render_image(scene: Scene, cam: camera_mod.Camera, cfg: RenderConfig,
                 seed: Optional[int] = None, device=None) -> torch.Tensor:
    """Render with ``cfg`` on ``device`` (default: the scene's device),
    returning (H, W, 3) f32 with row 0 at the bottom."""
    device = scene.device if device is None else device
    return make_renderer(cfg, device)(scene, cam, seed)
