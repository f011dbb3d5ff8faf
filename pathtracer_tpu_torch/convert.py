"""Carry a reference scene and its parameters into the port.

``scene_from_jax_arrays`` builds the port's Scene from the reference
Scene's fields given as numpy arrays (``{name: np.asarray(field)}``), so
both packages can be run on bit-identical geometry; ``params_from_jax``
does the same for a parameter dict of ``render/diff``, so both packages
differentiate the same numbers. Nothing here imports JAX; the caller does
the ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from pathtracer_tpu_torch.scene.scene import Scene, scene_from_numpy


def scene_from_jax_arrays(fields: dict, device="cuda") -> Scene:
    """Port Scene from a dict of numpy arrays keyed by Scene field name."""
    missing = set(Scene._fields) - set(fields)
    if missing:
        raise KeyError(f"missing scene fields: {sorted(missing)}")
    return scene_from_numpy(fields, device)


def params_from_jax(arrays: dict, device="cuda") -> dict:
    """Leaf tensors that require grad, on ``device``, from the reference's
    parameter dict (Scene field name -> numpy array)."""
    unknown = set(arrays) - set(Scene._fields)
    if unknown:
        raise KeyError(f"not scene fields: {sorted(unknown)}")
    return {name: torch.from_numpy(np.array(a)).to(device).requires_grad_()
            for name, a in arrays.items()}
