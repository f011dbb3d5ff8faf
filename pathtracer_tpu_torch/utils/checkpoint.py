"""Checkpoint and resume between spp passes (``utils/checkpoint.py``).

Radiance accumulates as a sum over sample indices and the random keys are
stateless (sample s of a pixel derives from the seed, s and the chunk's
first pixel), so a checkpoint is the accumulated framebuffer, the next
sample index and a fingerprint of the config. Stopping a render at any
pass boundary and resuming it gives the bit-identical image of an
uninterrupted render in passes of the same size.

The container is the reference's npz (same arrays, same fingerprint, so a
config fingerprints alike in both packages). The inverse-rendering fit's
state has an npz pair and, where the reference uses Orbax, a
``torch.save`` pair with the same payload.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from pathtracer_tpu_torch.config import RenderConfig

FORMAT_VERSION = 1


def _cfg_fingerprint(cfg: RenderConfig, scene_nprims: int) -> str:
    """Stable hash of everything that must match for a resume to be valid
    (the reference's payload)."""
    payload = json.dumps({
        "v": FORMAT_VERSION,
        "cfg": dataclasses.asdict(cfg),
        "n_prims": scene_nprims,
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _atomic_write(path: str, write) -> None:
    """``write(file)`` to a temporary file beside ``path``, then rename it
    over ``path``: a crash mid-save never corrupts the checkpoint."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _atomic_save(path: str, **arrays) -> None:
    """Write ``arrays`` as one npz, atomically."""
    _atomic_write(path, lambda f: np.savez(f, **arrays))


def _numpy(x) -> np.ndarray:
    """A host numpy copy of a tensor (detached) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_render_state(path: str, acc, next_sample: int, cfg: RenderConfig,
                      scene_nprims: int) -> None:
    _atomic_save(path,
                 acc=_numpy(acc).astype(np.float32, copy=False),
                 next_sample=np.int64(next_sample),
                 fingerprint=np.frombuffer(
                     _cfg_fingerprint(cfg, scene_nprims).encode(), np.uint8))


def load_render_state(path: str, cfg: RenderConfig,
                      scene_nprims: int) -> Optional[Tuple[np.ndarray, int]]:
    """Load (acc, next_sample) if the checkpoint matches; else None."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != _cfg_fingerprint(cfg, scene_nprims):
            return None
        return np.asarray(z["acc"]), int(z["next_sample"])


def render_with_checkpoints(scene, cam, cfg: RenderConfig,
                            path: Optional[str], spp_per_chunk: int = 16,
                            progress=None, device="cuda", renderer=None):
    """Render ``cfg.spp`` samples in passes of ``spp_per_chunk``
    (``Renderer.render_passes``); returns the gamma-2 image (H, W, 3)
    float32 on the render's device.

    The result is bit-identical to an uninterrupted render in passes of
    the same size (and differs from a one-pass render at ulp level).
    After each pass the framebuffer and the next sample index are saved
    atomically to ``path`` (None keeps nothing), and ``progress(done,
    total)`` is called; a matching checkpoint found at ``path`` is resumed
    from.

    ``renderer``: a :class:`~pathtracer_tpu_torch.render.renderer.Renderer`
    of ``cfg`` whose prepared query all passes share (default: one made on
    ``device``); where it was made ``with_stats``, returns (image, (queries,
    shadow queries, march pair tests)) summed over this call's passes."""
    from pathtracer_tpu_torch.render import renderer as renderer_mod

    if renderer is None:
        renderer = renderer_mod.make_renderer(cfg, device)
    elif renderer.cfg != cfg:
        raise ValueError("the renderer was made for another config")
    state = (load_render_state(path, cfg, scene.num_prims)
             if path is not None else None)

    def on_pass(acc, done):
        if path is not None:
            save_render_state(path, acc, done, cfg, scene.num_prims)
        if progress is not None:
            progress(done, cfg.spp)

    return renderer.render_passes(scene, cam, spp_per_chunk, resume=state,
                                  on_pass=on_pass)


# --- optimizer-state checkpointing for the inverse-rendering fit ---

def save_fit_state(path: str, params: dict, step: int,
                   loss_history) -> None:
    arrays = {f"param_{k}": _numpy(v) for k, v in params.items()}
    _atomic_save(path, step=np.int64(step),
                 loss_history=np.asarray(loss_history, np.float64),
                 **arrays)


def load_fit_state(path: str) -> Optional[Tuple[dict, int, list]]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        params = {k[len("param_"):]: np.asarray(z[k])
                  for k in z.files if k.startswith("param_")}
        return params, int(z["step"]), list(z["loss_history"])


# --- the fit state through torch.save (the reference's Orbax pair) ---

def save_fit_state_torch(path: str, params: dict, step: int,
                         loss_history) -> None:
    """``torch.save`` of the fit state: {"params": {name: CPU tensor},
    "step": int, "loss_history": float64 tensor}, written atomically."""
    payload = {
        "params": {k: torch.from_numpy(_numpy(v).copy())
                   for k, v in params.items()},
        "step": int(step),
        "loss_history": torch.tensor(list(loss_history),
                                     dtype=torch.float64),
    }
    _atomic_write(path, lambda f: torch.save(payload, f))


def load_fit_state_torch(path: str) -> Optional[Tuple[dict, int, list]]:
    """(params as numpy arrays, step, loss history) from
    :func:`save_fit_state_torch`'s file, or None where there is none.
    Loads tensors only (``weights_only``), never arbitrary objects."""
    if not os.path.exists(path):
        return None
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return ({k: v.numpy() for k, v in payload["params"].items()},
            int(payload["step"]), payload["loss_history"].tolist())
