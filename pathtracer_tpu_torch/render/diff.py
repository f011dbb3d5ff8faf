"""Differentiable rendering and the inverse-rendering fit
(``render/diff.py``).

Visibility is detached: which primitive wins a closest-hit query gets no
gradient, and the hit geometry is re-evaluated in closed form, so
gradients reach vertices, centers, albedos and emission
(``ops/intersect.hit_records_from_prims``). The queries run the same
kernels as the forward render, on detached inputs.

Trainable parameters are a dict of Scene tensor fields (default albedo and
emission; add "v0" for vertex and center gradients), held as leaf tensors
by a ``torch.optim`` optimizer. Over a mesh (``parallel/``) the train
step splits pixels over the rays axis and samples over the spp axis, and
its loss and gradients sum over both, as the reference's ``shard_map``
step with its ``psum`` does; across ranks the parameter gradients are
all-reduced before the optimizer steps.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.parallel.mesh import group_up
from pathtracer_tpu_torch.parallel.sharded import _shard_plan
from pathtracer_tpu_torch.render import renderer as renderer_mod
from pathtracer_tpu_torch.scene.scene import Scene

DEFAULT_PARAM_FIELDS = ("albedo", "emit")


def scene_params(scene: Scene, fields=DEFAULT_PARAM_FIELDS) -> Dict:
    """The trainable fields of ``scene`` as new leaf tensors that require
    grad (copies: an optimizer step does not write into ``scene``)."""
    return {f: getattr(scene, f).detach().clone().requires_grad_(True)
            for f in fields}


def apply_params(scene: Scene, params: Dict) -> Scene:
    """``scene`` with its fields replaced by ``params``."""
    return scene._replace(**params)


def render_linear(scene: Scene, cam, key, rows, cols, cfg: RenderConfig,
                  spp: int, sample_offset: int = 0):
    """Mean linear radiance per pixel, (P, 3): the differentiable forward
    (pre-gamma: gamma's sqrt has an unbounded derivative at 0, so losses
    are taken in linear space). Runs on the device of ``rows``."""
    acc, _ = renderer_mod.render_sum(scene, cam, key, rows, cols, cfg, spp,
                                     sample_offset=sample_offset,
                                     differentiable=True)
    return acc / spp


def paired_gradients(make, cfg: RenderConfig, devices,
                     fields=("albedo", "emit", "v0"), agree: float = 1e-4):
    """Gradients of mean(w * image^2) with respect to ``fields``, from the
    differentiable render of ``make(device)``'s (scene, camera) with
    ``cfg`` (key ``cfg.seed``) on each of two ``devices``: the kernels on
    the card held against the plain twins on the CPU. ``w`` keeps the
    pixels whose three channels agree within ``agree`` on both devices:
    outside it, a path sample took another way at a near tie under one
    device's rounding, which a single sample's share of a gradient sum
    cannot absorb. Returns (share of channels within ``agree``, share of
    pixels kept, each device's gradients as a dict of numpy arrays)."""
    runs = []
    for dev in devices:
        scene, cam = make(dev)
        params = scene_params(scene, fields)
        rows, cols = renderer_mod.padded_pixel_grid(cfg, cfg.ray_chunk, dev)
        img = render_linear(apply_params(scene, params), cam,
                            prng.PRNGKey(cfg.seed), rows, cols, cfg, cfg.spp)
        runs.append((img, params))
    close = ((runs[0][0].detach().cpu() - runs[1][0].detach().cpu()).abs()
             <= agree)
    keep = close.all(dim=1).float()
    grads = []
    for img, params in runs:
        torch.mean(keep.to(img.device)[:, None] * img ** 2).backward()
        grads.append({f: p.grad.cpu().numpy() for f, p in params.items()})
    return float(close.float().mean()), float(keep.mean()), *grads


def _loss_local(params, scene, cam, key, rows, cols, target, weight, cfg,
                spp, sample_offset=0):
    """(SSE, weighted channel count). ``weight`` is (P,) with 0 on the
    wavefront's padding rows, so they do not enter the objective."""
    img = render_linear(apply_params(scene, params), cam, key, rows, cols,
                        cfg, spp, sample_offset)
    err = img - target
    sse = torch.sum(weight[:, None] * err * err)
    return sse, torch.sum(weight) * 3.0


def make_train_step(cfg: RenderConfig, optimizer: torch.optim.Optimizer,
                    mesh=None, spp: Optional[int] = None):
    """An inverse-rendering step ``step(params, scene, cam, target, seed)
    -> loss``: the loss at ``params`` (mean squared error of the linear
    image against ``target``, (H*W or padded, 3), pixel order as the
    renderer's), its gradient, and one step of ``optimizer``, which holds
    the tensors of ``params``. Runs on ``scene``'s device, or with a
    ``mesh`` on its slots (:func:`_sharded_step`)."""
    spp = cfg.spp if spp is None else spp
    if mesh is not None:
        return _sharded_step(cfg, optimizer, mesh, spp)
    chunk = min(cfg.ray_chunk, cfg.num_pixels)
    cfg_local = cfg.replace(ray_chunk=chunk)

    def step(params, scene, cam, target, seed):
        rows, cols = renderer_mod.padded_pixel_grid(cfg, chunk, scene.device)
        n_padded = rows.shape[0]
        weight = _pixel_weights(cfg.num_pixels, n_padded, scene.device)
        target = _pad_target(target, n_padded)
        optimizer.zero_grad()
        sse, n = _loss_local(params, scene, cam, prng.PRNGKey(seed), rows,
                             cols, target, weight, cfg_local, spp)
        loss = sse / n
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _sharded_step(cfg: RenderConfig, optimizer, mesh, spp: int):
    """The train step over ``mesh``: rays slot r takes the r-th contiguous
    share of the padded pixels (the reference's plan and chunk), spp slot
    s the samples from s * spp / S; loss = (sum of the slots' SSE) / (sum
    of their weighted channel counts), its gradient summed over every
    slot (the parameters move to each slot's device and back through
    autograd) and, with a process group up, all-reduced across the ranks
    before ``optimizer.step()``.
    With an spp axis each slot's error is that of its own samples'
    estimate, as in the reference."""
    rays_size, _, spp_local, per_dev, chunk = _shard_plan(
        cfg.replace(spp=spp), mesh)
    n_padded = per_dev * rays_size
    cfg_local = cfg.replace(ray_chunk=chunk)
    slots = mesh.local_slots()

    def step(params, scene, cam, target, seed):
        rows, cols = renderer_mod.padded_pixel_grid(cfg, n_padded, "cpu")
        weight = _pixel_weights(cfg.num_pixels, n_padded, "cpu")
        target = _pad_target(target, n_padded)
        key = prng.PRNGKey(seed)
        home = next(iter(params.values())).device
        optimizer.zero_grad()
        sse = n = 0.0
        for r, s, dev in slots:
            sl = slice(r * per_dev, (r + 1) * per_dev)
            sse_s, n_s = _loss_local(
                {f: p.to(dev) for f, p in params.items()}, scene.to(dev),
                cam.to(dev), key, rows[sl].to(dev), cols[sl].to(dev),
                target[sl].to(dev), weight[sl].to(dev), cfg_local,
                spp_local, sample_offset=s * spp_local)
            sse = sse + sse_s.to(home)
            n = n + n_s.to(home)
        if group_up():
            dist.all_reduce(n)
        loss = sse / n
        loss.backward()
        loss = loss.detach()
        if group_up():
            for p in params.values():
                if p.grad is None:   # every rank must join each reduce
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad)
            dist.all_reduce(loss)
        optimizer.step()
        return loss

    return step


def _pixel_weights(n_pixels: int, n_padded: int, device):
    w = torch.zeros(n_padded, dtype=torch.float32, device=device)
    w[:n_pixels] = 1.0
    return w


def _pad_target(target, n_padded):
    target = target.reshape(-1, 3)
    pad = n_padded - target.shape[0]
    if pad > 0:
        target = torch.cat([target, target.new_zeros((pad, 3))])
    return target


def fit(scene: Scene, cam, target_img, cfg: RenderConfig, steps: int = 50,
        lr: float = 0.05, mesh=None, param_fields=DEFAULT_PARAM_FIELDS,
        spp: Optional[int] = None, seed: int = 0,
        resample: bool = True) -> Tuple[Dict, list]:
    """Small inverse-rendering fit with Adam (``optax.adam``'s defaults:
    betas (0.9, 0.999), eps 1e-8). Returns (fitted params, loss history).
    ``target_img`` is (H, W, 3) linear radiance. ``resample`` draws fresh
    sample jitter each step (SGD on the expectation); False freezes one
    noise realization, a deterministic objective whose minimum is exact
    when the target was rendered at the same (seed, spp). Runs on
    ``scene``'s device, or sharded over ``mesh``."""
    params = scene_params(scene, param_fields)
    optimizer = torch.optim.Adam(list(params.values()), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(cfg, optimizer, mesh=mesh, spp=spp)
    if not isinstance(target_img, torch.Tensor):
        target_img = torch.from_numpy(np.array(target_img, np.float32))
    target = target_img.to(scene.device, torch.float32).reshape(-1, 3)
    history = []
    for i in range(steps):
        loss = step(params, scene, cam, target, seed + i if resample else seed)
        history.append(float(loss))
    return {f: p.detach() for f, p in params.items()}, history
