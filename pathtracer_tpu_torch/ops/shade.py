"""The bounce's shading step through the hand-written shading kernel
(``csrc/shade_bounce.cu``): hit record, material scatter and path-state
update in one launch.

:func:`shade_bounce` picks by device only: a CUDA wavefront launches the
kernel or raises, a CPU one takes the plain twin, :func:`shade_reference`,
which is the torch composition the integrator runs everywhere else. Its
parts stay separate (:func:`surface`, :func:`absorb`, :func:`roulette`,
:func:`advance`) because the integrator's NEE and differentiable bounces
run the same parts with their own work between them. The kernel gives the
twin's bits, so an image does not depend on which ran.

The kernel replaces no Pallas kernel: it is the port's counterpart of the
XLA fusion that the JAX package's shading compiles to on the TPU (one
launch a bounce, where the twin dispatches some 340 torch ops).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pathtracer_tpu_torch.ops import _cuda_build, intersect
from pathtracer_tpu_torch.scene import materials
from pathtracer_tpu_torch.scene.scene import Scene

# the sorted payload's int32 word: ray id in bits 0-28, absorbed in bit 29,
# the NEE flag spec_prev in bit 30
ABSORBED_BIT = 29
RID_MASK = (1 << ABSORBED_BIT) - 1

# Russian roulette: continue probability and survivor scale
K_RR_CONTINUE = 0.8
K_RR_INV_CONTINUE = 1.25

# Launches of the shading kernel in this process (the wrapper adds one per
# launch and nowhere else); callers reset it to 0 to count a run.
SHADE_LAUNCHES = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_PROTOTYPES = {
    "shade_bounce_launch": [
        _LL, _P, _LL, _P, _LL, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _LL, _P, _P, _P, _P, _P,
        ctypes.c_float, ctypes.c_float, _P],
    "shade_math_launch": [ctypes.c_int, _P, _P, _LL, _P, _P],
}

MATH_FUNCTIONS = ("sin", "cos", "acos", "atan2", "pow5", "cbrt")


class ShadeTables(NamedTuple):
    """What a bounce shades with: the scene, its packed hit-field rows
    (``intersect.packed_hit_fields``) and its packed material rows
    (:func:`packed_material_fields`)."""
    scene: Scene
    prims: torch.Tensor   # (N, 16) f32
    mats: torch.Tensor    # (M, 12) f32


def packed_material_fields(scene: Scene):
    """(M, 12) f32 rows [mat_type, albedo, fuzz, ir, emit, tex_id, 0, 0]:
    one row a material, three float4 loads in the kernel."""
    m = scene.num_materials
    return torch.cat([
        scene.mat_type.to(torch.float32)[:, None], scene.albedo,
        scene.fuzz[:, None], scene.ir[:, None], scene.emit,
        scene.tex_id.to(torch.float32)[:, None],
        torch.zeros((m, 2), dtype=torch.float32, device=scene.device),
    ], dim=1)


def shade_tables(scene: Scene) -> ShadeTables:
    return ShadeTables(scene, intersect.packed_hit_fields(scene),
                       packed_material_fields(scene))


def surface(tables: ShadeTables, idx, o, d, hit_valid, u, t_min):
    """The hit record of each lane's winner and its material's scatter
    (``u`` (N, 6) the scatter uniforms): (rec, sc)."""
    rec = intersect.hit_records_from_prims(
        tables.scene, idx, o, d, t_min, intersect.BIG_T, hit_valid,
        packed=tables.prims)
    return rec, materials.scatter(tables.scene, rec, d, u)


def absorb(sc, alive, hit_valid, atten, emitted_acc, absorbed, emit_w=None):
    """A bounce's emission and absorption: (active, step, emitted_acc,
    absorbed), ``step`` the lanes whose path goes on. ``emit_w`` (N,)
    weighs the emission (NEE's balance heuristic)."""
    active = alive & hit_valid
    hit_emitter = active & sc.is_emissive
    emitted = atten * sc.emitted
    if emit_w is not None:
        emitted = emitted * emit_w[:, None]
    emitted_acc = emitted_acc + torch.where(hit_emitter[:, None], emitted,
                                            0.0)
    newly_absorbed = active & ~sc.is_emissive & ~sc.ok
    absorbed = absorbed | newly_absorbed | hit_emitter
    step = active & sc.ok & ~sc.is_emissive
    return active, step, emitted_acc, absorbed


def roulette(step, u_rr):
    """Russian roulette on the continuation: (killed, survivor scale)."""
    killed = step & (u_rr >= K_RR_CONTINUE)
    return killed, torch.where(step & ~killed, K_RR_INV_CONTINUE, 1.0)


def advance(rec, sc, step, o, d, atten, alive, hit_valid, absorbed,
            killed=None, rr_scale=None):
    """The next ray and state of each lane: (o, d, atten, alive,
    absorbed); a miss leaves the loop and keeps its last direction for the
    sky."""
    bounce_atten = atten * sc.attenuation
    if killed is not None:
        step = step & ~killed
        absorbed = absorbed | killed
        bounce_atten = bounce_atten * rr_scale[:, None]
    o = torch.where(step[:, None], rec.p, o)
    d = torch.where(step[:, None], sc.direction, d)
    atten = torch.where(step[:, None], bounce_atten, atten)
    alive = alive & hit_valid & step
    return o, d, atten, alive, absorbed


def decode_flags(flags):
    """(ray id, absorbed, spec_prev) of the sorted payload's word."""
    return (flags & RID_MASK, ((flags >> ABSORBED_BIT) & 1) != 0,
            ((flags >> (ABSORBED_BIT + 1)) & 1) != 0)


def encode_flags(rid, absorbed, spec_prev):
    return (rid | (absorbed.to(torch.int32) << ABSORBED_BIT)
            | (spec_prev.to(torch.int32) << (ABSORBED_BIT + 1)))


def shade_reference(tables: ShadeTables, idx, hit_valid, o, d, atten,
                    emitted, alive, absorbed, u, u_rr, t_min) -> None:
    """The plain twin of the kernel: :func:`shade_bounce`'s step as torch
    ops (:func:`surface`, :func:`absorb`, :func:`roulette`,
    :func:`advance`), its results written into the state in place."""
    flags = absorbed if absorbed.dtype == torch.int32 else None
    if flags is not None:
        rid, absorbed, spec_prev = decode_flags(flags)
    atten_t = torch.stack(atten, dim=1)
    rec, sc = surface(tables, idx, o, d, hit_valid, u, t_min)
    _, step, emitted_t, absorbed_n = absorb(
        sc, alive, hit_valid, atten_t, torch.stack(emitted, dim=1), absorbed)
    killed, rr_scale = (None, None) if u_rr is None else roulette(step, u_rr)
    o_n, d_n, atten_t, alive_n, absorbed_n = advance(
        rec, sc, step, o, d, atten_t, alive, hit_valid, absorbed_n, killed,
        rr_scale)
    o.copy_(o_n)
    d.copy_(d_n)
    alive.copy_(alive_n)
    for plane, col in zip(atten + emitted,
                          atten_t.unbind(1) + emitted_t.unbind(1)):
        plane.copy_(col)
    if flags is not None:
        flags.copy_(encode_flags(rid, absorbed_n, spec_prev))
    else:
        absorbed.copy_(absorbed_n)


def _planes(name: str, planes, n: int, dev) -> int:
    """The common element stride of three float32 (n,) planes on ``dev``."""
    if len(planes) != 3:
        raise ValueError(f"{name}: expected 3 planes, got {len(planes)}")
    stride = planes[0].stride(0) if n else 1
    for x in planes:
        if x.requires_grad:
            raise ValueError(f"{name} requires grad; pass it detached")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected {torch.float32}, got "
                            f"{x.dtype}")
        if tuple(x.shape) != (n,):
            raise ValueError(f"{name}: expected shape {(n,)}, got "
                             f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if n and x.stride(0) != stride:
            raise ValueError(f"{name}: the planes' strides differ")
    return stride


def _shade_cuda(tables: ShadeTables, idx, hit_valid, o, d, atten, emitted,
                alive, absorbed, u, u_rr, t_min) -> None:
    """One launch of ``csrc/shade_bounce.cu`` on the current stream."""
    global SHADE_LAUNCHES
    dev = o.device
    n = o.shape[0]
    tex = tables.scene.textures
    flags = absorbed if absorbed.dtype == torch.int32 else None
    for name, x, dtype, shape in (
            ("prims", tables.prims, torch.float32,
             (tables.prims.shape[0], 16)),
            ("mats", tables.mats, torch.float32, (tables.mats.shape[0], 12)),
            ("textures", tex, torch.float32, tuple(tex.shape[:3]) + (3,)),
            ("idx", idx, torch.int64, (n,)),
            ("hit_valid", hit_valid, torch.bool, (n,)),
            ("o", o, torch.float32, (n, 3)),
            ("d", d, torch.float32, (n, 3)),
            ("alive", alive, torch.bool, (n,)),
            ("absorbed", absorbed, torch.int32 if flags is not None
             else torch.bool, (n,)),
            ("u", u, torch.float32, (n, 6))):
        _cuda_build.check_arg(x, name, dtype, shape, dev)
    if u_rr is not None:
        _cuda_build.check_arg(u_rr, "u_rr", torch.float32, (n,), dev)
    a_stride = _planes("atten", atten, n, dev)
    e_stride = _planes("emitted", emitted, n, dev)
    if n == 0:
        return
    fn = _cuda_build.load("shade_bounce", _PROTOTYPES).shade_bounce_launch
    err = fn(n, tables.prims.data_ptr(), tables.prims.shape[0],
             tables.mats.data_ptr(), tables.mats.shape[0], tex.data_ptr(),
             tex.shape[0], tex.shape[1], tex.shape[2], idx.data_ptr(),
             hit_valid.data_ptr(), o.data_ptr(), d.data_ptr(),
             *(x.data_ptr() for x in atten), a_stride,
             *(x.data_ptr() for x in emitted), e_stride, alive.data_ptr(),
             None if flags is not None else absorbed.data_ptr(),
             None if flags is None else flags.data_ptr(), u.data_ptr(),
             None if u_rr is None else u_rr.data_ptr(), float(t_min),
             intersect.BIG_T, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shade_bounce kernel launch failed: CUDA error "
                           f"{err}")
    SHADE_LAUNCHES += 1


def shade_bounce(tables: ShadeTables, idx, hit_valid, o, d, atten, emitted,
                 alive, absorbed, u, u_rr, t_min) -> None:
    """Shade one bounce of a wavefront of N lanes, in place: the hit record
    of each lane's winner ``idx`` (int64, where ``hit_valid``), its
    material's scatter with the uniforms ``u`` (N, 6), and the update of
    the path state without NEE (emission, absorption, Russian roulette
    where ``u_rr`` (N,) is given, the next ray).

    State, written in place: ``o``, ``d`` (N, 3); ``atten`` and ``emitted``
    three (N,) float32 planes each, with one stride (the columns of an (N,
    3) tensor, or separate tensors); ``alive`` (N,) bool; ``absorbed`` (N,)
    bool, or the sorted payload's (N,) int32 word (bit
    ``ABSORBED_BIT``). The kernel on a CUDA wavefront, the twin
    :func:`shade_reference` on a CPU one."""
    if o.device.type == "cuda":
        return _shade_cuda(tables, idx, hit_valid, o, d, atten, emitted,
                           alive, absorbed, u, u_rr, t_min)
    if o.device.type == "cpu":
        return shade_reference(tables, idx, hit_valid, o, d, atten, emitted,
                               alive, absorbed, u, u_rr, t_min)
    raise ValueError(f"no shading for device {o.device}")


def math_kernel(fn: str, a, b=None) -> torch.Tensor:
    """The kernel's math library call ``fn`` (of ``MATH_FUNCTIONS``) on
    the CUDA float32 tensor ``a`` (and ``b`` for atan2), one launch: what
    the card tests hold to torch's op of the same function."""
    dev = a.device
    _cuda_build.check_arg(a, "a", torch.float32, tuple(a.shape), dev)
    if b is not None:
        _cuda_build.check_arg(b, "b", torch.float32, tuple(a.shape), dev)
    out = torch.empty_like(a)
    lib = _cuda_build.load("shade_bounce", _PROTOTYPES)
    err = lib.shade_math_launch(
        MATH_FUNCTIONS.index(fn), a.data_ptr(),
        None if b is None else b.data_ptr(), a.numel(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shade_math kernel launch failed: CUDA error "
                           f"{err}")
    return out
