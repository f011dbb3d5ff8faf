"""Wavefront path integrator (``render/integrator.py::trace``).

The bounce loop is a Python ``while`` over a whole wavefront that exits
once no lane is alive. Exit semantics follow the reference:

- miss         -> sky(last direction) * attenuation
- absorbed     -> black
- depth out    -> sky(last direction) * attenuation (the reference quirk;
                  ``terminate_black`` flips it to black)

- emissive hit -> accumulated emitted * attenuation (no sky term)

Sorted-wavefront mode (the cluster march's ``query_sorted``, R a multiple
of the chunk): the march's binning sort carries the per-ray state and the
wavefront stays in march order between bounces; one final unsort by ray id
restores pixel order. Otherwise each bounce queries in caller order.
Random draws are keyed by ray id, so they do not depend on lane order;
they go through the draws kernel's wrapper (``ops/uniforms``).

A bounce shades (hit record, scatter, state update) in one call of
``ops/shade.shade_bounce``, one launch of the shading kernel on the card,
which writes the state in place; in the sorted wavefront that state stays
in the march's payload layout, three planes and the flags word, between
bounces. Under NEE the shadow query comes between the light sample and
the emitted sum, so a bounce shades in two steps around it:
:func:`nee_bounce` (all that does not wait on the query, the next ray
included) and ``ops/shade.nee_finish`` (the light sample's share of the
emitted sum). On the card these are the launches ``ops/shade.shade_nee``
and ``ops/shade.shade_nee_finish``; elsewhere the same two steps in place
(:func:`shade_nee_reference`, ``ops/shade.shade_nee_finish_reference``).
Under ``differentiable`` the bounce runs the steps as torch ops
(``ops/shade``'s parts, :func:`nee_bounce`), which autograd needs.

Each trip of the loop is a ``pt.bounce`` span, each closest-hit and
shadow query a ``pt.query`` and the loop's test a ``pt.wait``
(``utils/metrics.span``, recorded only while a profiler records). Under
NEE a bounce holds two ``pt.light`` spans: the light sample's draw, and
its shadow ``pt.query`` with the direct-lighting sum after it. The
executed-query counts that depend on the data stay on the device.

With ``nee`` (scenes with emissive prims) every diffuse or fuzzy-metal hit
also samples one light point and casts a shadow ray (``render/lights``);
light samples and BSDF-sampled emissive hits are weighted by the one-sample
balance heuristic, while camera rays and paths after a delta lobe keep the
full emissive weight.

With ``rr`` (Russian roulette), from bounce ``rr_depth`` on a continuing
path survives with probability ``shade.K_RR_CONTINUE`` and its attenuation
is scaled by ``shade.K_RR_INV_CONTINUE``; the kill applies to the
continuation only, so the bounce's own emission and light sample keep
their full weight.

With ``differentiable``, visibility is detached: every closest-hit and
shadow query gets detached rays, in caller order (no sorted protocol), and
gradients reach the scene only through the hit fields re-evaluated from
the winner indices (``ops/intersect.hit_records_from_prims``), the
materials, the lights and the accumulation. The reference needs a
fixed-trip ``lax.scan`` there because reverse-mode AD cannot cross a
``lax.while_loop``; autograd crosses the Python ``while``, and the trips
after the last live lane would do nothing, so the early exit stays.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.core import vec
from pathtracer_tpu_torch.ops import intersect, shade, uniforms
from pathtracer_tpu_torch.render import lights
from pathtracer_tpu_torch.scene.scene import Scene
from pathtracer_tpu_torch.utils import metrics

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


def sky_color(direction):
    """Vertical white->blue gradient on the unit direction."""
    unit = vec.normalize(direction)
    t = 0.5 * (unit[..., 1] + 1.0)
    white = direction.new_tensor(SKY_WHITE)
    blue = direction.new_tensor(SKY_BLUE)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def make_brute_closest_hit(scene: Scene, t_min: float):
    """Closest hit by a dense scan over every primitive
    (``intersect.brute_force_closest``), hits in (t_min, BIG_T)."""
    def closest(o, d):
        return intersect.brute_force_closest(scene, o, d, t_min,
                                             intersect.BIG_T)
    return closest


def _any_alive(alive) -> bool:
    """The bounce loop's test: whether a lane is alive (a host wait)."""
    with metrics.span("pt.wait", "alive.any"):
        return bool(alive.any())


def _fused_shading(differentiable: bool) -> bool:
    """Whether each bounce shades through the shading kernels' wrappers
    (``ops/shade.shade_bounce``, or under NEE ``shade_nee`` and
    ``shade_nee_finish``; the kernels on the card, their twins on the CPU):
    everywhere but under autograd, which needs the torch composition."""
    return not differentiable


def nee_state(rec, sc, step, take_direct, spec_prev, prev_pdf):
    """The next bounce's NEE state where the path goes on: (spec_prev,
    prev_pdf). ``spec_prev``: the direction came from a delta lobe (fuzzy
    metal has a finite lobe and weighs emissive hits like diffuse), so an
    emitter it hits keeps the full weight; ``prev_pdf``: its solid-angle
    pdf, where the lane also took a light sample."""
    spec_prev = torch.where(step, sc.is_specular & ~sc.is_glossy, spec_prev)
    w_new = vec.safe_normalize(sc.direction)
    new_cos = torch.clamp(vec.dot(rec.normal, w_new), min=0.0)
    p_new = torch.where(sc.is_glossy,
                        lights.metal_lobe_pdf(w_new, sc.glossy_r, sc.fuzz),
                        new_cos * vec.PI_INV)
    return spec_prev, torch.where(step & take_direct, p_new, prev_pdf)


class NeeBounce(NamedTuple):
    """An NEE bounce up to its shadow query (:func:`nee_bounce`): the
    path's next state, and what crosses the query (the fields of
    ``ops/shade.NeeScratch``)."""
    o: torch.Tensor          # (N, 3)
    d: torch.Tensor          # (N, 3)
    atten: torch.Tensor      # (N, 3)
    alive: torch.Tensor      # (N,) bool
    absorbed: torch.Tensor   # (N,) bool
    spec_prev: torch.Tensor  # (N,) bool
    prev_pdf: torch.Tensor   # (N,) f32
    emitted: torch.Tensor    # (N, 3): the sum before the light sample's
    origin: torch.Tensor     # (N, 3): the shadow rays
    seg: torch.Tensor        # (N, 3)
    cand: torch.Tensor       # (N, 3): each light sample's share of the
    #                          emitted sum, should nothing occlude it
    take: torch.Tensor       # (N,) bool: the lanes that take a light sample


def nee_bounce(scene: Scene, rec, sc, o, d, atten, emitted, alive,
               hit_valid, absorbed, spec_prev, prev_pdf, u_nee, u_rr,
               t_min: float, handles_dead: bool) -> NeeBounce:
    """An NEE bounce of the hit record ``rec`` and scatter ``sc``
    (``ops/shade.surface``) up to its shadow query, as torch ops: the
    balance-heuristic weight of a BSDF-sampled emitter hit, emission and
    absorption, Russian roulette where ``u_rr`` is given, one light sample
    a diffuse or glossy hit from ``u_nee`` (N, 3) with its shadow ray (the
    segment zero off the sampling lanes where the route ``handles_dead``),
    the next bounce's NEE state and the next ray. The emitted sum still
    lacks the light samples: ``ops/shade.nee_finish`` adds them once the
    query has answered."""
    emit_w = torch.where(spec_prev, 1.0, lights.bsdf_hit_light_weight(
        scene, rec, d, prev_pdf))
    active, step, emitted, absorbed_n = shade.absorb(
        sc, alive, hit_valid, atten, emitted, absorbed, emit_w)
    killed, rr_scale = (None, None) if u_rr is None else shade.roulette(
        step, u_rr)
    # every diffuse or glossy hit takes a light sample, whether or not its
    # own BSDF sample survives (sc.ok)
    take = active & ~sc.is_emissive & (sc.is_diffuse | sc.is_glossy)
    light = lights.sample_lights(scene, u_nee)
    origin, seg = lights.shadow_segment(rec.p, rec.normal, light.point,
                                        t_min)
    direct, _ = lights.direct_lighting(seg, rec.normal, sc.attenuation,
                                       light,
                                       (sc.is_glossy, sc.glossy_r, sc.fuzz))
    if handles_dead:
        seg = torch.where(take[:, None], seg, 0.0)
    cand = torch.where(take[:, None], atten * direct, 0.0)
    spec_prev, prev_pdf = nee_state(rec, sc, step, take, spec_prev,
                                    prev_pdf)
    o, d, atten, alive, absorbed_n = shade.advance(
        rec, sc, step, o, d, atten, alive, hit_valid, absorbed_n, killed,
        rr_scale)
    return NeeBounce(o, d, atten, alive, absorbed_n, spec_prev, prev_pdf,
                     emitted, origin, seg, cand, take)


def shade_nee_reference(tables: shade.ShadeTables, idx, hit_valid, o, d,
                        atten, emitted, alive, absorbed, spec_prev, prev_pdf,
                        u, u_nee, u_rr, t_min, handles_dead: bool,
                        scratch: shade.NeeScratch) -> None:
    """The plain twin of ``ops/shade.shade_nee``, with its arguments:
    ``ops/shade.surface`` and :func:`nee_bounce`, their results written
    into the state and ``scratch`` in place."""
    flags = absorbed if absorbed.dtype == torch.int32 else None
    if flags is not None:
        rid, absorbed, spec_prev = shade.decode_flags(flags)
    rec, sc = shade.surface(tables, idx, o, d, hit_valid, u, t_min)
    x = nee_bounce(tables.scene, rec, sc, o, d, torch.stack(atten, dim=1),
                   torch.stack(emitted, dim=1), alive, hit_valid, absorbed,
                   spec_prev, prev_pdf, u_nee, u_rr, t_min, handles_dead)
    o.copy_(x.o)
    d.copy_(x.d)
    alive.copy_(x.alive)
    prev_pdf.copy_(x.prev_pdf)
    for plane, col in zip(atten + emitted,
                          x.atten.unbind(1) + x.emitted.unbind(1)):
        plane.copy_(col)
    if flags is not None:
        flags.copy_(shade.encode_flags(rid, x.absorbed, x.spec_prev))
    else:
        absorbed.copy_(x.absorbed)
        spec_prev.copy_(x.spec_prev)
    for field, value in zip(scratch, (x.origin, x.seg, x.cand, x.take)):
        field.copy_(value)


def trace(scene: Scene, origin, direction, key, max_depth: int,
          closest_hit_fn, t_min: float = 1e-3, sky: bool = True,
          terminate_black: bool = False, nee: bool = False, rr: bool = False,
          rr_depth: int = 3, differentiable: bool = False):
    """Trace a wavefront of rays; returns (radiance (N, 3), (counts,
    device_counts)): the executed (closest-hit queries, shadow queries,
    march pair tests) are ``counts`` (floats, what the host knows) plus
    the ``device_counts`` entries (slot, 0-d int64 tensor on the rays'
    device) of that slot, those that depend on the data, left on the
    device so that counting waits for nothing
    (``render/renderer.read_counts``).

    ``key`` is a threefry key (``core/random``); ``closest_hit_fn(o, d) ->
    (prim_idx, t, valid)`` over ``scene``'s rows, optionally with
    ``query_sorted`` and ``ray_tile`` (the cluster march) and
    ``handles_dead``; with ``nee`` it needs ``query_shadow`` (the shadow
    query, as every route of ``render/renderer`` has). ``rr`` turns on
    Russian roulette from bounce ``rr_depth`` on; ``differentiable``
    queries in caller order (module docstring). A query whose result
    carries autograd history (tables built from a scene that requires
    grad) raises: visibility must be detached."""
    n_rays = origin.shape[0]
    dev = origin.device
    use_nee = nee and scene.num_lights > 0
    # one kernel launch a bounce, two around the shadow query under NEE;
    # autograd needs the torch composition
    fused = _fused_shading(differentiable)
    handles_dead = getattr(closest_hit_fn, "handles_dead", False)
    query_sorted = (None if differentiable
                    else getattr(closest_hit_fn, "query_sorted", None))
    tile = getattr(closest_hit_fn, "ray_tile", 1)
    sorted_mode = query_sorted is not None and n_rays % tile == 0
    # the kernel takes no tensor that requires grad
    tables = shade.shade_tables(Scene(*(x.detach() for x in scene))
                                if fused else scene, nee=fused and use_nee)
    # emitted radiance stays zero without emissive prims: skip carrying it
    carry_emit = scene.num_lights > 0
    if fused and use_nee:
        # what crosses each NEE bounce's shadow query, and the kernel or,
        # off the card, its twin
        scratch = shade.nee_scratch(n_rays, dev)
        shade_nee = (shade.shade_nee if dev.type == "cuda"
                     else shade_nee_reference)

    o, d = origin, direction
    if fused:
        # the shading kernel writes the rays in place
        o, d = origin.detach().clone(), direction.detach().clone()
    atten = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n_rays, dtype=torch.bool, device=dev)
    absorbed = torch.zeros(n_rays, dtype=torch.bool, device=dev)
    emitted_acc = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    spec_prev = torch.ones(n_rays, dtype=torch.bool, device=dev)
    # solid-angle pdf of the bounce that chose the current direction
    prev_pdf = torch.zeros(n_rays, dtype=torch.float32, device=dev)
    rid = torch.arange(n_rays, dtype=torch.int32, device=dev)
    # the shading kernel's view of the state: (R,) planes, and in the sorted
    # wavefront the march's payload, where the ray id and flags share one
    # int32 word (ops/shade.encode_flags)
    atten_p, emit_p = atten.unbind(1), emitted_acc.unbind(1)
    flags = shade.encode_flags(rid, absorbed, spec_prev) if sorted_mode \
        else None
    counts = [0.0, 0.0, 0.0]
    device_counts = []

    def shadow_query(x, finish):
        """Count an NEE bounce's shadow rays (``x`` holds them, as
        ``ops/shade.NeeScratch`` does), query them and hand the answer
        (t, valid) to ``finish``; returns what ``finish`` does."""
        if handles_dead:
            device_counts.append((1, x.take.sum()))
        else:
            counts[1] += n_rays
        with metrics.span("pt.light", depth):
            with metrics.span("pt.query", "shadow"):
                _, t_sh, sh_valid = closest_hit_fn.query_shadow(
                    x.origin.detach(), x.seg.detach(),
                    x.take if handles_dead else None)
            return finish(t_sh, sh_valid)

    depth = 0
    while depth < max_depth and _any_alive(alive):
        with metrics.span("pt.bounce", depth):
            bkey = prng.fold_in(key, depth)
            if handles_dead or sorted_mode:
                device_counts.append((0, alive.sum()))
            else:
                counts[0] += n_rays
            if sorted_mode:
                extras = (*atten_p, flags)
                if carry_emit:
                    extras += emit_p
                if use_nee:
                    extras += (prev_pdf,)
                with metrics.span("pt.query", "closest"):
                    idx, _, hit_valid, o, d, alive, ex, pairs = query_sorted(
                        o.detach(), d.detach(), alive, extras)
                device_counts.append((2, pairs))
                atten_p, flags = ex[0:3], ex[3]
                if carry_emit:
                    emit_p = ex[4:7]
                if use_nee:
                    prev_pdf = ex[-1]
                rid = flags & shade.RID_MASK
            else:
                d_query = torch.where(alive[:, None], d, 0.0) if handles_dead \
                    else d
                with metrics.span("pt.query", "closest"):
                    idx, t_hit, hit_valid = closest_hit_fn(o.detach(),
                                                           d_query.detach())
                if t_hit.requires_grad:
                    raise RuntimeError(
                        "the closest-hit query carries autograd history: "
                        "build its tables from a detached scene (render/"
                        "renderer.make_query)")
            u_scatter = uniforms.uniform_by_ray(bkey, rid, 6)
            u_rr = None
            if rr and depth >= rr_depth:
                # decided for the continuation; the NEE bookkeeping still
                # sees the bounce's own step
                u_rr = uniforms.uniform_by_ray(prng.fold_in(bkey, 2), rid,
                                               1)[:, 0]
            if use_nee:
                with metrics.span("pt.light", depth):
                    u_nee = uniforms.uniform_by_ray(prng.fold_in(bkey, 1),
                                                    rid, 3)
            if fused and use_nee:
                shade_nee(tables, idx, hit_valid, o, d, atten_p, emit_p,
                          alive, flags if sorted_mode else absorbed,
                          None if sorted_mode else spec_prev, prev_pdf,
                          u_scatter, u_nee, u_rr, t_min, handles_dead,
                          scratch)
                shadow_query(scratch, lambda t_sh, sh_valid:
                             shade.shade_nee_finish(t_sh, sh_valid,
                                                    scratch.cand, emit_p,
                                                    t_min))
            elif fused:
                shade.shade_bounce(tables, idx, hit_valid, o, d, atten_p,
                                   emit_p, alive,
                                   flags if sorted_mode else absorbed,
                                   u_scatter, u_rr, t_min)
            else:
                if sorted_mode:
                    atten = torch.stack(atten_p, dim=1)
                    _, absorbed, spec_prev = shade.decode_flags(flags)
                    if carry_emit:
                        emitted_acc = torch.stack(emit_p, dim=1)
                rec, sc = shade.surface(tables, idx, o, d, hit_valid,
                                        u_scatter, t_min)
                if use_nee:
                    x = nee_bounce(scene, rec, sc, o, d, atten, emitted_acc,
                                   alive, hit_valid, absorbed, spec_prev,
                                   prev_pdf, u_nee, u_rr, t_min,
                                   handles_dead)
                    o, d, atten, alive, absorbed, spec_prev, prev_pdf = x[:7]
                    emitted_acc = shadow_query(
                        x, lambda t_sh, sh_valid: shade.nee_finish(
                            t_sh, sh_valid, x.cand, x.emitted, t_min))
                else:
                    _, step, emitted_acc, absorbed = shade.absorb(
                        sc, alive, hit_valid, atten, emitted_acc, absorbed)
                    killed = rr_scale = None
                    if u_rr is not None:
                        killed, rr_scale = shade.roulette(step, u_rr)
                    o, d, atten, alive, absorbed = shade.advance(
                        rec, sc, step, o, d, atten, alive, hit_valid,
                        absorbed, killed, rr_scale)
                if sorted_mode:
                    atten_p = atten.unbind(1)
                    flags = shade.encode_flags(rid, absorbed, spec_prev)
                    if carry_emit:
                        emit_p = emitted_acc.unbind(1)
            depth += 1

    if sorted_mode:
        atten = torch.stack(atten_p, dim=1)
        rid, absorbed, _ = shade.decode_flags(flags)
        if carry_emit:
            emitted_acc = torch.stack(emit_p, dim=1)
    if sky:
        background = sky_color(d)
    else:
        background = torch.zeros((n_rays, 3), dtype=torch.float32,
                                 device=dev)
    # depth-exhausted rays are still alive: sky * attenuation, as in the
    # reference, unless terminate_black
    dead = absorbed | alive if terminate_black else absorbed
    radiance = emitted_acc + torch.where(dead[:, None], 0.0,
                                         atten * background)
    if sorted_mode:
        # back to pixel order by ray id
        radiance = torch.empty_like(radiance).index_put_((rid.long(),),
                                                         radiance)
    return radiance, (tuple(counts), device_counts)
