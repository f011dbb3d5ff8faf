"""Carry a reference scene into the port.

``scene_from_jax_arrays`` builds the port's Scene from the reference
Scene's fields given as numpy arrays (``{name: np.asarray(field)}``), so
both packages can be run on bit-identical geometry. Nothing here imports
JAX; the caller does the ``np.asarray``.
"""
from __future__ import annotations

from pathtracer_tpu_torch.scene.scene import Scene, scene_from_numpy


def scene_from_jax_arrays(fields: dict, device="cuda") -> Scene:
    """Port Scene from a dict of numpy arrays keyed by Scene field name."""
    missing = set(Scene._fields) - set(fields)
    if missing:
        raise KeyError(f"missing scene fields: {sorted(missing)}")
    return scene_from_numpy(fields, device)

