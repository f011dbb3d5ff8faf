"""Dense closest hit through the hand-written sweep kernel
(``ops/pallas_sweep.py``, ``accel="pallas"``).

Every ray is tested against every primitive of the sweep tables
(``ops/tensor_sweep.pack_sweep_tables``): pair scalars, the sphere or
triangle epilogue, and a running (t, index) merged with a strict ``<`` over
the primitives in ascending order, so the lowest index wins ties.

The sweep has two implementations: the CUDA kernel
(``csrc/dense_sweep.cu``) for tensors on a GPU, and ``sweep_reference``,
its plain PyTorch twin, for tensors on the CPU. ``sweep`` picks by device
only; on a GPU it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from pathtracer_tpu_torch.core import vec
from pathtracer_tpu_torch.ops import _cuda_build
from pathtracer_tpu_torch.ops.tensor_sweep import (BIG, FEAT, OUTS,
                                                   SweepTables, _epilogue,
                                                   check_ranges, contract,
                                                   merge_tile,
                                                   pack_sweep_tables,
                                                   ray_features, row_ranges)
from pathtracer_tpu_torch.scene.scene import Scene

DEF_PRIM_TILE = 1024

# Launches of the CUDA sweep kernel in this process (the wrapper adds one per
# launch and nowhere else); callers reset it to 0 to count a run.
SWEEP_LAUNCHES = 0

_PROTOTYPES = {"dense_sweep_launch": (
    [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3)}


def sweep_reference(phi, a, cols, is_sphere, ranges, t_min: float,
                    t_max: float):
    """Plain PyTorch twin of the CUDA sweep kernel: same inputs, same
    (t_best (R,) f32, best (R,) int32), ``best`` -1 where nothing is hit.

    Per tile i, over its rows [lo, hi) = ranges[i] only: the left-to-right
    contraction, the epilogue, the range's first minimum and a strict-``<``
    merge into the running best. Raises ValueError where a range leaves
    its tile."""
    n_tiles, tile = is_sphere.shape
    check_ranges(ranges, tile)
    r = phi.shape[0]
    a2 = a[:, None]
    t_best = torch.full((r,), BIG, dtype=torch.float32, device=phi.device)
    best = torch.full((r,), -1, dtype=torch.int32, device=phi.device)
    for i, (lo, hi) in enumerate(ranges.tolist()):
        n = hi - lo
        if n == 0:
            continue
        S = contract(phi, cols[i].view(FEAT, OUTS, tile)[:, :, lo:hi]
                     .reshape(FEAT, OUTS * n))
        t_eff = _epilogue(S[:, 0:n], S[:, n:2 * n], S[:, 2 * n:3 * n],
                          S[:, 3 * n:4 * n], a2, is_sphere[i, lo:hi] != 0,
                          True, t_min, t_max)
        t_best, best = merge_tile(t_eff, i * tile + lo, t_best, best)
    return t_best, best


def _sweep_cuda(phi, a, cols, is_sphere, ranges, t_min, t_max):
    global SWEEP_LAUNCHES
    n_tiles, tile = is_sphere.shape
    r = phi.shape[0]
    for name, x, dtype, shape in (
            ("phi", phi, torch.float32, (r, FEAT)),
            ("a", a, torch.float32, (r,)),
            ("cols", cols, torch.float32, (n_tiles, FEAT, OUTS * tile)),
            ("is_sphere", is_sphere, torch.int32, (n_tiles, tile)),
            ("ranges", ranges, torch.int32, (n_tiles, 2))):
        _cuda_build.check_arg(x, name, dtype, shape, phi.device)
    fn = _cuda_build.load("dense_sweep", _PROTOTYPES).dense_sweep_launch
    t_out = torch.empty(r, dtype=torch.float32, device=phi.device)
    best = torch.empty(r, dtype=torch.int32, device=phi.device)
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    err = fn(phi.data_ptr(), a.data_ptr(), r, cols.data_ptr(),
             is_sphere.data_ptr(), ranges.data_ptr(), n_tiles, tile, t_min,
             t_max, t_out.data_ptr(), best.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dense_sweep kernel launch failed: CUDA error "
                           f"{err}")
    SWEEP_LAUNCHES += 1
    return t_out, best


def sweep(phi, a, cols, is_sphere, ranges, t_min: float, t_max: float):
    """The dense sweep: the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors. phi (R, 12), a = |d|^2 (R,), cols (T, 12, 4*tile),
    is_sphere (T, tile) int32, ranges (T, 2) int32: the rows [lo, hi) of
    each tile to sweep. Returns (t_best (R,) f32, best (R,) int32),
    ``best`` -1 where nothing is hit. A range that leaves its tile raises
    ValueError in the twin and fails a device-side assert in the kernel
    (PyTorch raises at the next sync)."""
    if phi.device.type == "cuda":
        return _sweep_cuda(phi, a, cols, is_sphere, ranges, t_min, t_max)
    if phi.device.type == "cpu":
        return sweep_reference(phi, a, cols, is_sphere, ranges, t_min, t_max)
    raise ValueError(f"no dense sweep for device {phi.device}")


def kernel_tables(tables: SweepTables):
    """(cols, is_sphere, ranges) of ``tables`` as :func:`sweep` takes them:
    the int32 sphere mask, and each tile's valid rows [0, n) as its range,
    the only rows swept (``valid_row`` is a prefix of each tile;
    ValueError otherwise)."""
    ranges = row_ranges(tables.valid_row)
    if bool((ranges[:, 0] != 0).any()):
        raise ValueError("valid_row is not a prefix of each tile")
    return (tables.cols, tables.is_sphere.to(torch.int32).contiguous(),
            ranges)


def sweep_inputs(kt, o, d, t_min, t_max=BIG):
    """The arguments of :func:`sweep` for rays (o, d) against the
    :func:`kernel_tables` ``kt``."""
    return (ray_features(o, d), vec.dot(d, d), *kt, float(t_min),
            float(t_max))


def _closest(kt, o, d, t_min, t_max):
    t_best, best = sweep(*sweep_inputs(kt, o, d, t_min, t_max))
    found = best >= 0
    return torch.where(found, best, 0).to(torch.int64), t_best, found


def pallas_closest(tables: SweepTables, o, d, t_min, t_max=BIG):
    """Dense closest hit: (prim_idx (R,) int64, t (R,), valid (R,) bool),
    hits in (t_min, t_max); ties go to the lowest index."""
    return _closest(kernel_tables(tables), o, d, t_min, t_max)


def make_pallas_closest_hit(scene: Scene, t_min: float,
                            tile: int = DEF_PRIM_TILE):
    """Closest-hit function ``closest(o, d) -> (idx, t, valid)`` over
    ``scene`` through the sweep kernel, hits in (t_min, BIG)."""
    kt = kernel_tables(pack_sweep_tables(scene, tile=tile))

    def closest(o, d):
        return _closest(kt, o, d, t_min, BIG)
    return closest
