"""The bounce's shading step through the hand-written shading kernels
(``csrc/shade_bounce.cu``): hit record, material scatter and path-state
update in one launch; under next-event estimation (NEE), in two launches
around the bounce's shadow query.

:func:`shade_bounce` and :func:`shade_nee_finish` pick by device: a CUDA
wavefront launches the kernel or raises, a CPU one takes the plain twin
(:func:`shade_reference`, :func:`shade_nee_finish_reference`).
:func:`shade_nee` (all of an NEE bounce that does not wait on the shadow
query) launches its kernel on a CUDA wavefront only: its twin,
``render/integrator.shade_nee_reference``, is the integrator's own NEE
composition split at the query, and the integrator runs it on the CPU.
The parts stay separate (:func:`surface`, :func:`absorb`,
:func:`roulette`, :func:`advance`, :func:`nee_finish`) because the
differentiable bounce runs the same parts as torch ops under autograd.
Each kernel gives its twin's bits, so an image does not depend on which
ran.

The kernels replace no Pallas kernel: they are the port's counterpart of
the XLA fusion that the JAX package's shading compiles to on the TPU (one
launch a bounce, where the twin dispatches some 340 torch ops; two under
NEE, where it dispatches some 600).
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

# Launches of the shading kernel, and of each kernel of the NEE pair (one
# each a bounce under NEE), in this process (the wrappers add one per
# launch and nowhere else); callers reset them to 0 to count a run.
SHADE_LAUNCHES = 0
SHADE_NEE_LAUNCHES = 0
SHADE_NEE_FINISH_LAUNCHES = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_PROTOTYPES = {
    "shade_bounce_launch": [
        _LL, _P, _LL, _P, _LL, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _LL, _P, _P, _P, _P, _P,
        ctypes.c_float, ctypes.c_float, _P],
    "shade_nee_launch": [
        _LL, _P, _LL, _P, _LL, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P, _LL, _P, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _LL, _P, _P, _P,
        _P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        _P, _P, _P, _P, _P],
    "shade_nee_finish_launch": [_LL, _P, _P, _P, _P, _P, _P, _LL,
                                ctypes.c_float, _P],
    "shade_math_launch": [ctypes.c_int, _P, _P, _LL, _P, _P],
}

MATH_FUNCTIONS = ("sin", "cos", "acos", "atan2", "pow5", "cbrt", "cube")


class ShadeTables(NamedTuple):
    """What a bounce shades with: the scene, its packed hit-field rows
    (``intersect.packed_hit_fields``), its packed material rows
    (:func:`packed_material_fields`) and, for NEE only, its packed emitter
    rows (:func:`packed_light_fields`)."""
    scene: Scene
    prims: torch.Tensor   # (N, 16) f32
    mats: torch.Tensor    # (M, 12) f32
    lights: torch.Tensor | None  # (L, 20) f32, or None without NEE


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


def packed_light_fields(scene: Scene, prims):
    """(L, 20) f32 rows [prim_type, v0, e1, e2, radius, tri_normal, emit,
    0, 0, 0]: one row an emitter (``scene.light_idx``), five float4 loads
    in the kernel; ``prims`` is ``intersect.packed_hit_fields(scene)``."""
    lv = scene.light_idx.long()
    return torch.cat([
        prims[lv, :14], scene.emit[scene.prim_mat[lv].long()],
        torch.zeros((lv.shape[0], 3), dtype=torch.float32,
                    device=scene.device),
    ], dim=1)


def shade_tables(scene: Scene, nee: bool = False) -> ShadeTables:
    """``scene``'s tables; the emitter rows only where ``nee`` asks for
    them (:func:`shade_nee` reads them, :func:`shade_bounce` does not)."""
    prims = intersect.packed_hit_fields(scene)
    return ShadeTables(scene, prims, packed_material_fields(scene),
                       packed_light_fields(scene, prims) if nee else None)


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


def nee_finish(t_sh, sh_valid, cand, emitted, t_min):
    """The emitted sum (N, 3) with each lane's light sample ``cand`` (N,
    3) added where its shadow query (``t_sh``, ``sh_valid``) found nothing
    short of the light: a hit with t < 1 - ``t_min`` occludes."""
    unoccluded = (~sh_valid) | (t_sh >= 1.0 - t_min)
    return emitted + torch.where(unoccluded[:, None], cand, 0.0)


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


def _check_bounce(tables: ShadeTables, idx, hit_valid, o, d, atten,
                  emitted, alive, absorbed, u, u_rr):
    """What a shading kernel takes of a bounce, checked before its pointers
    are passed: (the flags word or None, the attenuation's and the emitted
    sum's plane strides)."""
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
    return flags, _planes("atten", atten, n, dev), _planes("emitted",
                                                           emitted, n, dev)


def _shade_cuda(tables: ShadeTables, idx, hit_valid, o, d, atten, emitted,
                alive, absorbed, u, u_rr, t_min) -> None:
    """One launch of ``csrc/shade_bounce.cu`` on the current stream."""
    global SHADE_LAUNCHES
    dev = o.device
    n = o.shape[0]
    tex = tables.scene.textures
    flags, a_stride, e_stride = _check_bounce(
        tables, idx, hit_valid, o, d, atten, emitted, alive, absorbed, u,
        u_rr)
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


class NeeScratch(NamedTuple):
    """What crosses a bounce's shadow query under NEE, N lanes, written by
    :func:`shade_nee`."""
    origin: torch.Tensor  # (N, 3) f32: the shadow rays' origins
    seg: torch.Tensor     # (N, 3) f32: their segments to the light points
    cand: torch.Tensor    # (N, 3) f32: each light sample's share of the
    #                       emitted sum, should nothing occlude it
    take: torch.Tensor    # (N,) bool: the lanes that take a light sample


def nee_scratch(n: int, device) -> NeeScratch:
    """An uninitialised :class:`NeeScratch` of ``n`` lanes on ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    return NeeScratch(torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
                      torch.empty((n, 3), **f32),
                      torch.empty(n, dtype=torch.bool, device=device))


def shade_nee_finish_reference(t_sh, sh_valid, cand, emitted,
                               t_min) -> None:
    """The plain twin of the second NEE kernel: :func:`nee_finish` on the
    emitted sum's three planes, written into them in place."""
    emitted_t = nee_finish(t_sh, sh_valid, cand, torch.stack(emitted, dim=1),
                           t_min)
    for plane, col in zip(emitted, emitted_t.unbind(1)):
        plane.copy_(col)


def _shade_nee_cuda(tables: ShadeTables, idx, hit_valid, o, d, atten,
                    emitted, alive, absorbed, spec_prev, prev_pdf, u, u_nee,
                    u_rr, t_min, handles_dead, scratch) -> None:
    """One launch of ``shade_nee_kernel`` on the current stream."""
    global SHADE_NEE_LAUNCHES
    dev = o.device
    n = o.shape[0]
    tex = tables.scene.textures
    flags, a_stride, e_stride = _check_bounce(
        tables, idx, hit_valid, o, d, atten, emitted, alive, absorbed, u,
        u_rr)
    if (flags is None) == (spec_prev is None):
        raise ValueError("spec_prev: a bool plane with a bool absorbed, "
                         "None with the payload's flags word")
    if tables.lights is None:
        raise ValueError("shade_nee needs the emitter rows: build the "
                         "tables with shade_tables(scene, nee=True)")
    n_lights = tables.lights.shape[0]
    if n_lights < 1:
        raise ValueError("shade_nee needs a scene with emitters")
    for name, x, dtype, shape in (
            ("lights", tables.lights, torch.float32, (n_lights, 20)),
            ("prev_pdf", prev_pdf, torch.float32, (n,)),
            ("u_nee", u_nee, torch.float32, (n, 3)),
            ("scratch.origin", scratch.origin, torch.float32, (n, 3)),
            ("scratch.seg", scratch.seg, torch.float32, (n, 3)),
            ("scratch.cand", scratch.cand, torch.float32, (n, 3)),
            ("scratch.take", scratch.take, torch.bool, (n,))):
        _cuda_build.check_arg(x, name, dtype, shape, dev)
    if spec_prev is not None:
        _cuda_build.check_arg(spec_prev, "spec_prev", torch.bool, (n,), dev)
    if n == 0:
        return
    fn = _cuda_build.load("shade_bounce", _PROTOTYPES).shade_nee_launch
    err = fn(n, tables.prims.data_ptr(), tables.prims.shape[0],
             tables.mats.data_ptr(), tables.mats.shape[0], tex.data_ptr(),
             tex.shape[0], tex.shape[1], tex.shape[2],
             tables.lights.data_ptr(), n_lights, idx.data_ptr(),
             hit_valid.data_ptr(), o.data_ptr(), d.data_ptr(),
             *(x.data_ptr() for x in atten), a_stride,
             *(x.data_ptr() for x in emitted), e_stride, alive.data_ptr(),
             None if flags is not None else absorbed.data_ptr(),
             None if flags is None else flags.data_ptr(),
             None if spec_prev is None else spec_prev.data_ptr(),
             prev_pdf.data_ptr(), u.data_ptr(), u_nee.data_ptr(),
             None if u_rr is None else u_rr.data_ptr(), float(t_min),
             intersect.BIG_T, int(bool(handles_dead)),
             *(x.data_ptr() for x in scratch),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shade_nee kernel launch failed: CUDA error "
                           f"{err}")
    SHADE_NEE_LAUNCHES += 1


def _shade_nee_finish_cuda(t_sh, sh_valid, cand, emitted, t_min) -> None:
    """One launch of ``shade_nee_finish_kernel`` on the current stream."""
    global SHADE_NEE_FINISH_LAUNCHES
    dev = cand.device
    n = cand.shape[0]
    for name, x, dtype, shape in (
            ("t_sh", t_sh, torch.float32, (n,)),
            ("sh_valid", sh_valid, torch.bool, (n,)),
            ("cand", cand, torch.float32, (n, 3))):
        _cuda_build.check_arg(x, name, dtype, shape, dev)
    e_stride = _planes("emitted", emitted, n, dev)
    if n == 0:
        return
    fn = _cuda_build.load("shade_bounce",
                          _PROTOTYPES).shade_nee_finish_launch
    err = fn(n, t_sh.data_ptr(), sh_valid.data_ptr(), cand.data_ptr(),
             *(x.data_ptr() for x in emitted), e_stride, 1.0 - t_min,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shade_nee_finish kernel launch failed: CUDA "
                           f"error {err}")
    SHADE_NEE_FINISH_LAUNCHES += 1


def shade_nee(tables: ShadeTables, idx, hit_valid, o, d, atten, emitted,
              alive, absorbed, spec_prev, prev_pdf, u, u_nee, u_rr, t_min,
              handles_dead: bool, scratch: NeeScratch) -> None:
    """Shade one NEE bounce of a wavefront of N lanes up to its shadow
    query, in place: as :func:`shade_bounce`, and besides the
    balance-heuristic weight of a BSDF-sampled emitter hit, one light
    sample a lane from the uniforms ``u_nee`` (N, 3) over the emitters of
    ``tables.lights`` (``shade_tables(scene, nee=True)``), and the next
    bounce's NEE state (``render/integrator.nee_state``).

    State as :func:`shade_bounce`'s, and ``prev_pdf`` (N,) float32;
    ``spec_prev`` (N,) bool with a bool ``absorbed``, None with the
    payload's flags word (bit ``ABSORBED_BIT`` + 1). Writes ``scratch``
    (:func:`nee_scratch` of N lanes): the shadow rays, with a zero segment
    where ``handles_dead`` and the lane takes no light sample, for
    ``closest_hit_fn.query_shadow``, and each sample's share of the emitted
    sum for :func:`shade_nee_finish`. The kernel, on a CUDA wavefront
    only: the twin, ``render/integrator.shade_nee_reference``, runs the
    integrator's composition on any device."""
    if o.device.type != "cuda":
        raise ValueError(f"shade_nee launches a CUDA kernel; the wavefront "
                         f"is on {o.device} (its twin is render/integrator."
                         f"shade_nee_reference)")
    return _shade_nee_cuda(tables, idx, hit_valid, o, d, atten, emitted,
                           alive, absorbed, spec_prev, prev_pdf, u, u_nee,
                           u_rr, t_min, handles_dead, scratch)


def shade_nee_finish(t_sh, sh_valid, cand, emitted, t_min) -> None:
    """Add each lane's light sample ``cand`` (:class:`NeeScratch`) to its
    emitted sum (three (N,) float32 planes with one stride, in place) where
    its shadow query (``t_sh`` (N,) float32, ``sh_valid`` (N,) bool) found
    no occluder short of the light (t < 1 - ``t_min``). The kernel on a
    CUDA wavefront, the twin :func:`shade_nee_finish_reference` on a CPU
    one."""
    if cand.device.type == "cuda":
        return _shade_nee_finish_cuda(t_sh, sh_valid, cand, emitted, t_min)
    if cand.device.type == "cpu":
        return shade_nee_finish_reference(t_sh, sh_valid, cand, emitted,
                                          t_min)
    raise ValueError(f"no shading for device {cand.device}")


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
