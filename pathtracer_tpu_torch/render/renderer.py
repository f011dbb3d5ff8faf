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

Closest-hit routes (``cfg.accel``; "auto" by scene size and device,
``config.route_accel``): "cluster" (the march kernel, or with
``PT_CLUSTER_STRATEGY=rounds`` the window kernel; "auto" at or above
K_AUTO_ACCEL_PRIMS prims), "pallas" (the dense sweep kernel; "auto" below
it on a CUDA device), "tensor" (dense float32 matrix products; "auto"
below it elsewhere, as in the reference), "bvh" (the LBVH and the
stackless traversal kernel, a correctness cross-check) and "brute".
Every route carries a shadow query for NEE. ``stratify`` jitters sample s
inside stratum (s mod m^2) of an m x m sub-pixel grid, m the
largest integer with m^2 dividing ``cfg.spp``; ``sampler="sobol"`` takes
the pixel jitter from a per-pixel Owen-scrambled Sobol point instead (and
overrides ``stratify``).

Kernel-facing tables are always built from the detached scene, so no
kernel input carries autograd history; the scene a query shades with
stays connected to the caller's tensors (on the cluster route, their rows
gathered in cluster order). ``render_sum(differentiable=True)`` is the
differentiable pass of ``render/diff``: visibility detached, gradients
through the re-evaluated hits, materials, lights and accumulation
(``render/integrator``).
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import torch

from pathtracer_tpu_torch import config as config_mod
from pathtracer_tpu_torch.accel.lbvh import build_lbvh
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.core import camera as camera_mod
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.core.sampling import sobol_owen_2d
from pathtracer_tpu_torch.ops import uniforms
from pathtracer_tpu_torch.ops.cluster_sweep import make_cluster_closest_hit
from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
from pathtracer_tpu_torch.ops.pallas_sweep import make_pallas_closest_hit
from pathtracer_tpu_torch.ops.tensor_sweep import make_tensor_closest_hit
from pathtracer_tpu_torch.ops.traversal import (make_bvh_closest_hit,
                                              pack_fat_nodes)
from pathtracer_tpu_torch.render import integrator
from pathtracer_tpu_torch.scene.scene import Scene
from pathtracer_tpu_torch.utils import metrics

# Cluster size (``PT_CLUSTER_K`` overrides). The reference picks 64 unless
# its tables would overflow TPU VMEM, a limit the port does not have. On
# an H100, K=128 was slower than 64 on the bunny and on its level-3
# subdivision, and faster only at level 2 (PERF.md §6).
CLUSTER_K = 64


class Query(NamedTuple):
    """A scene prepared for one closest-hit route."""
    closest: Callable   # closest(o, d) -> (idx, t, valid), + query_shadow
    scene: Scene        # the scene its indices address (shade with it)


def cluster_options():
    """(K, factory keywords) of the cluster route from the reference's
    environment knobs: ``PT_CLUSTER_K`` (default :data:`CLUSTER_K`),
    ``PT_CLUSTER_STRATEGY`` ("march" or "rounds"), ``PT_CLUSTER_RAY_TILE``
    (rays per chunk; the factory also reads ``PT_CLUSTER_RAYTILE``, which
    wins), ``PT_CLUSTER_WINDOW``, ``PT_CLUSTER_MAX_ROUNDS`` (the rounds
    strategy's), ``PT_CLUSTER_SORT=0`` (no binning sort) and the march's
    cull plan: ``PT_CLUSTER_CULL2`` ("1" or "0" forces the two-level cull
    on or off; else it is on from ``PT_CLUSTER_CULL2_C`` regular clusters,
    default 2048) and ``PT_CLUSTER_SUPER`` (clusters per supercluster).
    Read when a scene's route is built, so a :class:`Renderer` keeps the
    route it built first."""
    K = int(os.environ.get("PT_CLUSTER_K") or CLUSTER_K)
    kw = {}
    for name, var in (("ray_tile", "RAY_TILE"), ("window", "WINDOW"),
                      ("max_rounds", "MAX_ROUNDS"), ("sup", "SUPER"),
                      ("cull2_clusters", "CULL2_C")):
        value = os.environ.get(f"PT_CLUSTER_{var}")
        if value:
            kw[name] = int(value)
    if os.environ.get("PT_CLUSTER_SORT", "1") == "0":
        kw["sort_rays"] = False
    cull2 = os.environ.get("PT_CLUSTER_CULL2", "auto")
    if cull2 not in ("auto", ""):
        kw["cull2"] = cull2 == "1"
    strategy = os.environ.get("PT_CLUSTER_STRATEGY")
    if strategy:
        kw["strategy"] = strategy
    return K, kw


def _with_shadow(factory, scene: Scene, t_min: float):
    """``factory(scene, t_min)`` with a ``query_shadow`` built by the same
    factory at the near-zero K_SHADOW_T_MIN: the shadow segment's origin is
    already offset off the surface (render/lights), and the segment is
    unnormalized, so a bounce t_min would be a window proportional to the
    light's distance."""
    closest = factory(scene, t_min)
    shadow = factory(scene, config_mod.K_SHADOW_T_MIN)
    closest.query_shadow = lambda o, d, active=None: shadow(o, d)
    return closest


def make_query(scene: Scene, cfg: RenderConfig) -> Query:
    """The closest-hit route ``cfg.accel`` selects for ``scene``, built on
    the scene's device from its detached tensors; the query's scene is
    ``scene`` itself, or on the cluster route its rows in cluster order
    (``ClusterTables.scene``), so gradients reach the caller's tensors.
    The "bvh" route builds the scene's LBVH here."""
    accel = config_mod.route_accel(cfg.accel, scene.num_prims, scene.device)
    if accel == "cluster":
        K, kw = cluster_options()
        ct = build_cluster_tables(scene, K=K)
        return Query(make_cluster_closest_hit(ct, cfg.t_min, **kw), ct.scene)
    detached = Scene(*(x.detach() for x in scene))
    if accel == "bvh":
        bvh = build_lbvh(detached)
        nodes = pack_fat_nodes(detached, bvh)

        def factory(sc, t_min):
            return make_bvh_closest_hit(sc, bvh, t_min, nodes=nodes)
    else:
        factory = {"tensor": make_tensor_closest_hit,
                   "pallas": make_pallas_closest_hit,
                   "brute": integrator.make_brute_closest_hit}[accel]
    return Query(_with_shadow(factory, detached, cfg.t_min), scene)


def _stratum_grid(spp: int) -> int:
    """Largest m with m^2 dividing spp."""
    m = max(1, int(spp ** 0.5))
    while m > 1 and spp % (m * m) != 0:
        m -= 1
    return m


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


def padded_pixel_grid(cfg: RenderConfig, multiple: int, device="cuda"):
    """(rows, cols) flat f32 grids of ``cfg``'s image on ``device``,
    zero-padded to a multiple of ``multiple``."""
    n_padded = -(-cfg.num_pixels // multiple) * multiple
    return _pixel_grid(cfg.width, cfg.height, n_padded, device)


def render_sum(scene: Scene, cam: camera_mod.Camera, base_key, rows, cols,
               cfg: RenderConfig, spp: int, query: Optional[Query] = None,
               sample_offset: int = 0, differentiable: bool = False):
    """Radiance SUM (P, 3) over ``spp`` samples for a flat pixel wavefront
    (P a multiple of the chunk), not averaged or gamma'd, and the executed
    (closest-hit queries, shadow queries, march pair tests), floats; the
    counts that depend on the data stay on the device until the end,
    where one wait reads them all (:func:`read_counts`).

    ``query`` is :func:`make_query` of ``scene`` (built here when None);
    shading uses its scene. ``sample_offset`` is the global index of the
    first sample: sample s keys and stratifies as sample ``sample_offset +
    s``. Chunk keys derive from the first pixel's global index, so a
    pixel's samples do not depend on the chunking. ``differentiable`` runs
    the integrator's differentiable pass (caller-order detached queries);
    the result then carries autograd history from ``scene``'s tensors."""
    # full float32 everywhere: TF32 would round the sweep's operands
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if query is None:
        query = make_query(scene, cfg)
    n_padded = rows.shape[0]
    chunk = min(cfg.ray_chunk, n_padded)
    n_chunks = n_padded // chunk
    if n_chunks * chunk != n_padded:
        raise ValueError("wavefront must be chunk-aligned")
    w_inv = 1.0 / cfg.width
    h_inv = 1.0 / cfg.height
    dev = rows.device
    m_strat = _stratum_grid(cfg.spp) if cfg.stratify else 1
    inv_m = 1.0 / m_strat
    use_sobol = cfg.sampler == "sobol"
    # each chunk's key: its first pixel's global index, in float32 as the
    # reference computes it (a chunk of padding alone keys 0)
    pix0 = (rows[::chunk] * cfg.width + cols[::chunk]).to(torch.int32)
    with metrics.span("pt.wait", "chunk keys"):
        pix0 = pix0.tolist()

    acc = torch.zeros((n_padded, 3), dtype=torch.float32, device=dev)
    counts = (0.0, 0.0, 0.0)
    device_counts = []
    for s in range(sample_offset, sample_offset + spp):
        skey = prng.fold_in(base_key, s)
        stratum = s % (m_strat * m_strat)
        sx, sy = float(stratum % m_strat), float(stratum // m_strat)
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            row, col = rows[sl], cols[sl]
            ckey = prng.fold_in(skey, pix0[c])
            pkey, tkey, lkey1, lkey2 = prng.split(ckey, 4)
            if use_sobol:
                # sample s of each lane's own pixel (float32 arithmetic,
                # exact below 2^24 pixels, as in the reference)
                pix_id = (row * cfg.width + col).to(torch.int64)
                xi = torch.stack(sobol_owen_2d(s, pix_id, cfg.seed))
            else:
                xi = uniforms.uniform(pkey, (2, chunk), dev)
                if m_strat > 1:
                    xi = torch.stack([(sx + xi[0]) * inv_m,
                                      (sy + xi[1]) * inv_m])
            u = (col + xi[0]) * w_inv
            v = (row + xi[1]) * h_inv
            u_disk = uniforms.uniform(lkey1, (2, chunk), dev)
            u_time = uniforms.uniform(lkey2, (chunk,), dev)
            # shutter time is unused: no ported scene moves
            o, d, _ = camera_mod.get_rays(cam, u, v, u_disk[0], u_disk[1],
                                          u_time)
            radiance, (chunk_counts, chunk_device_counts) = integrator.trace(
                query.scene, o, d, tkey, cfg.max_depth, query.closest,
                t_min=cfg.t_min, sky=cfg.sky,
                terminate_black=cfg.terminate_black, nee=cfg.nee, rr=cfg.rr,
                rr_depth=cfg.rr_depth, differentiable=differentiable)
            acc[sl] += radiance
            counts = tuple(a + b for a, b in zip(counts, chunk_counts))
            device_counts += chunk_device_counts
    return acc, read_counts(counts, device_counts)


def read_counts(counts, device_counts):
    """``counts`` (floats) plus each ``device_counts`` entry (slot, 0-d
    integer tensor) added into its slot, read from the device in one wait.
    Every count is an integer below 2^53, so the floats are exact."""
    if not device_counts:
        return counts
    with metrics.span("pt.wait", "counters"):
        values = torch.stack([c for _, c in device_counts]).tolist()
    out = list(counts)
    for (slot, _), v in zip(device_counts, values):
        out[slot] += v
    return tuple(out)


def finish_image(acc, cfg: RenderConfig) -> torch.Tensor:
    """The displayed (H, W, 3) image of a raster-order framebuffer ``acc``
    (P >= H*W, 3) holding the sums of ``cfg.spp`` samples: the mean,
    clamped at 0, through gamma 2."""
    img = torch.sqrt(torch.clamp(acc[:cfg.num_pixels], min=0.0) / cfg.spp)
    return img.reshape(cfg.height, cfg.width, 3)


class Renderer:
    """``render(scene, cam, seed) -> (H, W, 3)`` for one config on one
    device; a scene's closest-hit route (cluster tables or sweep tables)
    is built once and cached."""

    def __init__(self, cfg: RenderConfig, device="cuda",
                 with_stats: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.with_stats = with_stats
        self._queries: dict = {}   # id(scene) -> (scene, Query)

    def prepare(self, scene: Scene) -> Query:
        """The cached :class:`Query` of ``scene`` on this device."""
        hit = self._queries.get(id(scene))
        if hit is not None and hit[0] is scene:
            return hit[1]
        query = make_query(scene.to(self.device), self.cfg)
        self._queries = {id(scene): (scene, query)}
        return query

    def __call__(self, scene: Scene, cam: camera_mod.Camera,
                 seed: Optional[int] = None):
        return self.render_passes(scene, cam, self.cfg.spp, seed=seed)

    def render_passes(self, scene: Scene, cam: camera_mod.Camera,
                      spp_per_pass: int, seed: Optional[int] = None,
                      resume=None, on_pass=None):
        """The gamma-2 image (H, W, 3) of ``cfg.spp`` samples rendered in
        passes of ``spp_per_pass`` (with ``with_stats``, also the executed
        (queries, shadow queries, march pair tests) of these passes).

        Each pass is ``acc + render_sum(...)`` of its samples from zero,
        the reference's addition order: a render in passes is
        bit-identical to any other in passes of the same size, and one
        pass is the one-pass render (0 + x == x). ``resume`` is a stopped
        render's (framebuffer (P, 3), next sample index); ``on_pass(acc,
        done)`` is called after each pass with the framebuffer and the
        samples done."""
        cfg = self.cfg
        if spp_per_pass < 1:
            raise ValueError(f"spp per pass must be positive, got "
                             f"{spp_per_pass}")
        n_pixels = cfg.num_pixels
        rows, cols = padded_pixel_grid(cfg, min(cfg.ray_chunk, n_pixels),
                                       self.device)
        query = self.prepare(scene)
        if resume is None:
            acc = torch.zeros((rows.shape[0], 3), dtype=torch.float32,
                              device=self.device)
            s = 0
        else:
            acc, s = resume
            if tuple(acc.shape) != (rows.shape[0], 3):
                raise ValueError(f"framebuffer {tuple(acc.shape)}, "
                                 f"expected {(rows.shape[0], 3)}")
            acc = torch.as_tensor(acc, dtype=torch.float32,
                                  device=self.device)
        base_key = prng.PRNGKey(cfg.seed if seed is None else seed)
        cam = cam.to(self.device)
        stats = (0.0, 0.0, 0.0)
        while s < cfg.spp:
            n = min(spp_per_pass, cfg.spp - s)
            with metrics.span("pt.pass", (s, n)):
                part, part_stats = render_sum(scene, cam, base_key, rows,
                                              cols, cfg, n, query,
                                              sample_offset=s)
                acc = acc + part
            stats = tuple(a + b for a, b in zip(stats, part_stats))
            s += n
            if on_pass is not None:
                on_pass(acc, s)
        img = finish_image(acc, cfg)
        return (img, stats) if self.with_stats else img


def make_renderer(cfg: RenderConfig, device="cuda",
                  with_stats: bool = False):
    """A :class:`Renderer` for ``cfg`` on ``device``."""
    return Renderer(cfg, device, with_stats=with_stats)


def render_image(scene: Scene, cam: camera_mod.Camera, cfg: RenderConfig,
                 seed: Optional[int] = None, device="cuda") -> torch.Tensor:
    """Render with ``cfg`` on ``device`` (the scene and camera move there),
    returning (H, W, 3) f32 with row 0 at the bottom. ``device="cpu"`` runs
    the plain twins of the kernels."""
    return make_renderer(cfg, device)(scene, cam, seed)
