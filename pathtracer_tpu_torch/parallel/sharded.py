"""Sharded rendering over the (rays, spp) mesh (``parallel/sharded.py``).

The flattened framebuffer is split across the ``rays`` axis and the
samples across the ``spp`` axis; every slot runs the single-device
wavefront core (``render/renderer.render_sum``) on its share, the sample
sums add over the spp axis and the shares gather over the rays axis.
Without a process group that happens on the first slot's device; with
one, one ``all_reduce`` of the framebuffer, zero outside each rank's
shares, does both. Every rank returns the whole image.

Each chunk's random keys derive from its first pixel's global index and
the global sample index, so every (pixel, sample) radiance is a function
of (seed, chunk layout) alone, whichever slot computed it: on a rays-only
mesh the image equals the single-device render with the plan's chunk bit
for bit; with an spp axis, up to the order of the sample sums.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.parallel.mesh import (RAYS_AXIS, SPP_AXIS, Mesh,
                                                group_up)
from pathtracer_tpu_torch.render import renderer as renderer_mod

# Chunks per rays slot for the round-robin interleave: a contiguous raster
# band per slot balances badly (sky bands end after one bounce, geometry
# bands trace whole paths); striding chunks across the frame gives each
# slot a cross-section of the scene.
K_INTERLEAVE = 4


def _shard_plan(cfg: RenderConfig, mesh: Mesh):
    """(rays slots, spp slots, samples a slot, pixels a rays slot (whole
    chunks), chunk), the reference's plan number for number: a chunk of at
    most max(ceil(n / (R * K_INTERLEAVE)), 1024) rays."""
    rays_size = mesh.shape[RAYS_AXIS]
    spp_size = mesh.shape[SPP_AXIS]
    if cfg.spp % spp_size != 0:
        raise ValueError(f"spp={cfg.spp} not divisible by spp axis "
                         f"size {spp_size}")
    spp_local = cfg.spp // spp_size
    n_pixels = cfg.num_pixels
    chunk = min(cfg.ray_chunk, -(-n_pixels // rays_size))
    target = -(-n_pixels // (rays_size * K_INTERLEAVE))
    if chunk > max(target, 1024):
        chunk = max(target, 1024)
    per_dev = -(-n_pixels // (rays_size * chunk)) * chunk
    return rays_size, spp_size, spp_local, per_dev, chunk


def frame_all_reduce_bytes(cfg: RenderConfig, mesh: Mesh) -> int:
    """Bytes of the framebuffer that one sharded render of ``cfg`` over
    ``mesh`` hands to ``dist.all_reduce`` with a process group up: (R *
    per_dev, 3) float32."""
    rays_size, _, _, per_dev, _ = _shard_plan(cfg, mesh)
    return rays_size * per_dev * 3 * 4


def _gather_rays(mesh: Mesh, shares: dict, per_dev: int):
    """(R * per_dev, ...) in rays-slot order from ``shares`` {r: this
    process's sum over its spp slots of rays slot r}: concatenated on the
    first slot's device without a process group; with one, summed over
    the ranks by one all_reduce (on this rank's first slot's device)."""
    rays_size = mesh.shape[RAYS_AXIS]
    if not group_up():
        dev = mesh.devices[0][0]
        return torch.cat([shares[r].to(dev) for r in range(rays_size)])
    first = next(iter(shares.values()))
    full = first.new_zeros((rays_size, per_dev) + tuple(first.shape[1:]))
    for r, share in shares.items():
        full[r] = share.to(full.device)
    dist.all_reduce(full)
    return full.reshape((rays_size * per_dev,) + tuple(first.shape[1:]))


def make_sharded_renderer(cfg: RenderConfig, mesh: Mesh,
                          with_stats: bool = False):
    """``render(scene, cam, seed=None) -> (H, W, 3)`` sharded over
    ``mesh`` (with ``with_stats``, also the executed (queries, shadow
    queries, march pair tests) of this process's slots). A slot's device
    builds the scene's route once (``Renderer.prepare``);
    ``render.prepare(scene)`` builds it on every slot's device ahead of
    the first render."""
    rays_size, _, spp_local, per_dev, chunk = _shard_plan(cfg, mesh)
    n_padded = per_dev * rays_size
    cfg_local = cfg.replace(ray_chunk=chunk)
    n_chunks = n_padded // chunk
    per_dev_chunks = per_dev // chunk
    # round robin: rays slot r renders chunks r, r + R, r + 2R, ...; each
    # chunk keeps its pixels, so only the slot that computes it moves
    perm = torch.arange(n_chunks).reshape(per_dev_chunks, rays_size).T
    rows0, cols0 = renderer_mod.padded_pixel_grid(cfg, n_padded, "cpu")
    rows0 = rows0.view(n_chunks, chunk)[perm.reshape(-1)].view(rays_size,
                                                               per_dev)
    cols0 = cols0.view(n_chunks, chunk)[perm.reshape(-1)].view(rays_size,
                                                               per_dev)
    slots = mesh.local_slots()
    renderers = {}
    for _, _, dev in slots:
        renderers.setdefault(dev, renderer_mod.Renderer(cfg_local, dev))

    def render(scene, cam, seed=None):
        base_key = prng.PRNGKey(cfg.seed if seed is None else seed)
        shares = {}
        stats = (0.0, 0.0, 0.0)
        for r, s, dev in slots:
            query = renderers[dev].prepare(scene)
            acc, slot_stats = renderer_mod.render_sum(
                query.scene, cam.to(dev), base_key, rows0[r].to(dev),
                cols0[r].to(dev), cfg_local, spp_local, query,
                sample_offset=s * spp_local)
            shares[r] = acc if r not in shares else \
                shares[r] + acc.to(shares[r].device)
            stats = tuple(a + b for a, b in zip(stats, slot_stats))
        acc = _gather_rays(mesh, shares, per_dev)
        # device-major chunk order back to raster order
        acc = acc.view(rays_size, per_dev_chunks, chunk, 3).transpose(
            0, 1).reshape(n_padded, 3)
        img = renderer_mod.finish_image(acc, cfg)
        return (img, stats) if with_stats else img

    def prepare(scene):
        """Build the scene's route on every slot's device now."""
        for rnd in renderers.values():
            rnd.prepare(scene)
    render.prepare = prepare
    return render


def sharded_render_image(scene, cam, cfg: RenderConfig, mesh: Mesh):
    """Render ``cfg`` (seed ``cfg.seed``) sharded over ``mesh``."""
    return make_sharded_renderer(cfg, mesh)(scene, cam)
