"""Uniform draws through the hand-written draws kernel
(``csrc/ray_uniforms.cu``).

Every random draw of a render goes through this module: the camera's flat
draws (:func:`uniform`, mode "flat") and the integrator's draws keyed by
ray id (:func:`uniform_by_ray`, mode "by_ray"). Each function picks by
device only: a CPU tensor takes the plain twin (``core/random.uniform``,
``core/random.uniform_by_ray``), a CUDA tensor launches the kernel or
raises. The kernel gives the twin's bits, so an image does not depend on
which ran.

The kernel replaces no Pallas kernel: it is the port's counterpart of the
XLA fusion that each ``jax.random`` draw set compiles to on the TPU (one
launch per draw set, where the twin dispatches some 185-365 int64 ops).
"""
from __future__ import annotations

import ctypes

import torch

from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.ops import _cuda_build

MODES = ("flat", "by_ray")

# Launches of the draws kernel in this process (the wrapper adds one per
# launch and nowhere else); callers reset it to 0 to count a run.
UNIFORMS_LAUNCHES = 0

_PROTOTYPES = {"ray_uniforms_launch": [
    ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]}


def _launch(mode: str, key, rid, n: int, m: int, device) -> torch.Tensor:
    """One launch of the kernel in ``mode``: (n,) float32 for "flat",
    (n, m) for "by_ray", allocated here on ``device``."""
    global UNIFORMS_LAUNCHES
    shape = (n,) if mode == "flat" else (n, m)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if n == 0:
        return out
    if rid is not None:
        _cuda_build.check_arg(rid, "rid", torch.int32, (n,), device)
    fn = _cuda_build.load("ray_uniforms", _PROTOTYPES).ray_uniforms_launch
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(MODES.index(mode), int(key[0]), int(key[1]),
             None if rid is None else rid.data_ptr(), n, m, out.data_ptr(),
             stream)
    if err != 0:
        raise RuntimeError(f"ray_uniforms kernel launch failed ({mode}): "
                           f"CUDA error {err}")
    UNIFORMS_LAUNCHES += 1
    return out


def uniform(key, shape, device) -> torch.Tensor:
    """float32 uniforms of ``shape`` in [0, 1), bit-equal to
    ``jax.random.uniform(key, shape)``: the kernel's "flat" mode on a CUDA
    device, its twin on the CPU."""
    device = torch.device(device)
    shape = tuple(shape)
    if device.type == "cuda":
        n = 1
        for s in shape:
            n *= s
        return _launch("flat", key, None, n, 1, device).reshape(shape)
    if device.type == "cpu":
        return prng.uniform(key, shape, device)
    raise ValueError(f"no uniform draws for device {device}")


def uniform_by_ray(key, rid: torch.Tensor, m: int) -> torch.Tensor:
    """(R, m) float32 uniforms keyed by the ray ids ``rid`` (R,): row r
    equals ``jax.random.uniform(jax.random.fold_in(key, rid[r]), (m,))``.
    The kernel for a CUDA ``rid``, the twin for a CPU one. Ids are taken
    modulo 2^32, as uint32 words (an int64 ``rid`` is cast to int32 for the
    kernel, which keeps the same low 32 bits)."""
    if m < 1:
        raise ValueError(f"m must be positive, got {m}")
    if rid.dim() != 1:
        raise ValueError(f"rid must be 1-d, got shape {tuple(rid.shape)}")
    if rid.device.type == "cuda":
        rid32 = rid.to(torch.int32).contiguous()
        return _launch("by_ray", key, rid32, rid.shape[0], m, rid.device)
    if rid.device.type == "cpu":
        return prng.uniform_by_ray(key, rid, m)
    raise ValueError(f"no uniform draws for device {rid.device}")
