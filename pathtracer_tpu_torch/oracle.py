"""CPU reference oracle (``oracle.py``): a plain NumPy renderer of the
reference algorithm, independent of the port's tensor code.

Integrator loop (a miss returns sky * attenuation, a failed scatter
black, an exhausted depth sky(last scattered direction) * attenuation),
thin-lens camera rays with unnormalised directions, material scatter,
intersections in their factored forms (two-root sphere; Moller-Trumbore
with all six barycentric rejections and the ``det == 0`` parallel
reject) and a brute-force closest hit whose ties go to the lowest index:
float32 NumPy over the port's own scene construction (``scene_to_np``
reads a torch Scene from any device).

Its random numbers come from ``numpy.random.default_rng(seed)`` by
vectorised rejection sampling, so they are not the renderer's streams:
converged images agree in expectation, and ``compare_to_torch`` measures
the oracle-vs-port difference against the port's difference from itself
at two seeds. The same scene and seed give the same bits as the JAX
package's oracle.

    python -m pathtracer_tpu_torch.oracle --scene test --compare \
        [--device cpu]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from pathtracer_tpu_torch.scene.scene import (
    MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_METAL, PRIM_SPHERE, Scene)

F = np.float32
INF = F(3.0e38)  # kInfinityGPU stand-in (global_variables.h)


class SceneNp(NamedTuple):
    """Host copies of the Scene fields the oracle reads."""
    prim_type: np.ndarray
    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    radius: np.ndarray
    tri_normal: np.ndarray
    prim_mat: np.ndarray
    mat_type: np.ndarray
    albedo: np.ndarray
    fuzz: np.ndarray
    ir: np.ndarray


def _np(x, dtype=F):
    """A tensor (any device) or array as a host array of ``dtype``."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def scene_to_np(scene: Scene) -> SceneNp:
    """Host copies of a port Scene's fields (from any device)."""
    sn = SceneNp(*[_np(getattr(scene, f), F if f not in
                       ("prim_type", "prim_mat", "mat_type") else np.int32)
                   for f in SceneNp._fields])
    if not np.all(np.isin(sn.mat_type,
                          (MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC))):
        raise ValueError("oracle covers the reference's material set only "
                         "(lambertian/metal/dielectric, material.h:13-15)")
    return sn


# ---------------------------------------------------------------- sampling

def _in_unit_sphere(rng, n: int) -> np.ndarray:
    """Vectorized randomInUnitSphereDiscard (utility.h:73-82)."""
    out = np.empty((n, 3), F)
    todo = np.arange(n)
    while todo.size:
        cand = (2.0 * (rng.random((todo.size, 3), dtype=np.float32) - 0.5)
                ).astype(F)
        ok = np.sum(cand * cand, axis=1) < 1.0
        out[todo[ok]] = cand[ok]
        todo = todo[~ok]
    return out


def _on_unit_sphere(rng, n: int) -> np.ndarray:
    """randomOnUnitSphereDiscard (utility.h:51-62): rejection-sampled
    interior point, then normalized."""
    v = _in_unit_sphere(rng, n)
    return v / np.sqrt(np.sum(v * v, axis=1, keepdims=True)).astype(F)


def _in_unit_disk(rng, n: int) -> np.ndarray:
    """randomInUnitDisk (utility.h:98-102): r = sqrt(u), uniform angle."""
    r = np.sqrt(rng.random(n, dtype=np.float32)).astype(F)
    theta = (rng.random(n, dtype=np.float32) * F(2.0 * np.pi)).astype(F)
    return np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)


# ------------------------------------------------------------------ camera

def get_rays(cam, s, t, rng):
    """camera.h:58-64: thin-lens ray per (s, t) viewport fraction.
    Directions are NOT normalized. ``cam`` is the port's Camera."""
    pos = _np(cam.position)
    right = _np(cam.right)
    up = _np(cam.up)
    low = _np(cam.lower_left)
    horiz = _np(cam.horizontal)
    vert = _np(cam.vertical)
    lens_r = F(_np(cam.lens_radius))
    rd = lens_r * _in_unit_disk(rng, s.shape[0])
    offset = right[None, :] * rd[:, 0:1] + up[None, :] * rd[:, 1:2]
    o = pos[None, :] + offset
    d = (low[None, :] + s[:, None] * horiz[None, :]
         + t[:, None] * vert[None, :] - pos[None, :] - offset)
    return o.astype(F), d.astype(F)


# ------------------------------------------------------------- closest hit

def closest_hit(sn: SceneNp, o, d, t_min: float, t_max: float):
    """Brute-force scan over every primitive (render_manager.h:71-84 is the
    reference's own pre-LBVH path; the LBVH only changes *which* candidates
    are tested, never the verdict). Factored formulas from
    cuda_object.h:45-90. Returns (idx, t, valid); ties go to the lowest
    primitive index (the reference's in-order scan keeps the first hit on a
    strict-inequality tie)."""
    t_min, t_max = F(t_min), F(t_max)
    sph = sn.prim_type == PRIM_SPHERE
    n = sn.prim_type.shape[0]
    r = o.shape[0]
    t_all = np.full((r, n), INF, F)

    if np.any(sph):
        c = sn.v0[sph]                       # (S, 3)
        rad = sn.radius[sph]                 # (S,)
        oc = o[:, None, :] - c[None, :, :]   # (R, S, 3)
        a = np.sum(d * d, axis=1)[:, None]   # (R, 1)
        half_b = np.sum(oc * d[:, None, :], axis=2)
        cterm = np.sum(oc * oc, axis=2) - (rad * rad)[None, :]
        disc = half_b * half_b - a * cterm
        pos = disc >= 0.0
        sq = np.sqrt(np.where(pos, disc, 0.0)).astype(F)
        root0 = (-half_b - sq) / a
        root1 = (-half_b + sq) / a
        ok0 = ~((root0 < t_min) | (t_max < root0))
        ok1 = ~((root1 < t_min) | (t_max < root1))
        t_sph = np.where(ok0, root0, root1)
        hit = pos & (ok0 | ok1)
        t_all[:, sph] = np.where(hit, t_sph, INF)

    tri = ~sph
    if np.any(tri):
        v0 = sn.v0[tri]
        e1 = sn.e1[tri]
        e2 = sn.e2[tri]
        s1 = np.cross(d[:, None, :], e2[None, :, :])          # (R, T, 3)
        det = np.sum(s1 * e1[None, :, :], axis=2)
        s = o[:, None, :] - v0[None, :, :]
        s2 = np.cross(s, e1[None, :, :])
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = F(1.0) / det
            t_tri = np.sum(s2 * e2[None, :, :], axis=2) * inv
            b1 = np.sum(s1 * s, axis=2) * inv
            b2 = np.sum(s2 * d[:, None, :], axis=2) * inv
        # the reference's exact six rejections + parallel + t-range
        # (cuda_object.h:84-85); all strict
        miss = ((det == 0.0)
                | (b1 >= 1.0) | (b1 <= 0.0) | (b2 >= 1.0) | (b2 <= 0.0)
                | (b1 + b2 <= 0.0) | (b1 + b2 >= 1.0)
                | (t_tri <= t_min) | (t_tri >= t_max))
        t_all[:, tri] = np.where(miss, INF, t_tri)

    idx = np.argmin(t_all, axis=1).astype(np.int32)
    t = t_all[np.arange(r), idx]
    return idx, t, t < INF


def _hit_normal(sn: SceneNp, idx, o, d, t):
    """hit_record fields at the winner: p, face normal with front-face flip
    (hit_record.h:21-25). Sphere outward normal divides by the SIGNED
    radius (cuda_object.h:64) — negative radius inverts it (hollow glass)."""
    p = o + t[:, None] * d
    is_sph = sn.prim_type[idx] == PRIM_SPHERE
    outward_sph = (p - sn.v0[idx]) / np.where(
        sn.radius[idx] == 0, F(1), sn.radius[idx])[:, None]
    outward = np.where(is_sph[:, None], outward_sph, sn.tri_normal[idx])
    front = np.sum(d * outward, axis=1) < 0.0
    normal = np.where(front[:, None], outward, -outward).astype(F)
    return p.astype(F), normal, front


# ----------------------------------------------------------------- scatter

def _reflect(v, n):
    return v - 2.0 * np.sum(v * n, axis=1, keepdims=True) * n


def _refract(uv, n, ratio):
    """physical.h:14-19."""
    cos_theta = np.minimum(np.sum(-uv * n, axis=1), F(1.0))
    r_perp = ratio[:, None] * (uv + cos_theta[:, None] * n)
    r_par = (-np.sqrt(np.abs(1.0 - np.sum(r_perp * r_perp, axis=1)))
             )[:, None] * n
    return (r_perp + r_par).astype(F)


def _reflectance(cosine, ref_idx):
    """Schlick (physical.h:20-25)."""
    r0 = ((1.0 - ref_idx) / (1.0 + ref_idx)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(sn: SceneNp, idx, p, normal, front, d_in, rng):
    """material.h:28-61, vectorized. Returns (ok, attenuation, direction)."""
    r = idx.shape[0]
    mat = sn.prim_mat[idx]
    mtype = sn.mat_type[mat]
    atten = np.ones((r, 3), F)
    direction = np.zeros((r, 3), F)
    ok = np.ones(r, bool)

    lam = mtype == MAT_LAMBERTIAN
    if np.any(lam):
        nl = normal[lam]
        sd = nl + _on_unit_sphere(rng, int(lam.sum()))
        # near_zero -> fall back to the normal (material.h:33-34,
        # vec3.h:66-69: all components < 1e-7)
        nz = np.all(np.abs(sd) < 1e-7, axis=1)
        sd = np.where(nz[:, None], nl, sd)
        direction[lam] = sd
        atten[lam] = sn.albedo[mat[lam]]

    met = mtype == MAT_METAL
    if np.any(met):
        dm = d_in[met]
        unit = dm / np.sqrt(np.sum(dm * dm, axis=1, keepdims=True))
        refl = _reflect(unit.astype(F), normal[met])
        sd = refl + sn.fuzz[mat[met]][:, None] * _in_unit_sphere(
            rng, int(met.sum()))
        direction[met] = sd
        atten[met] = sn.albedo[mat[met]]
        ok[met] = np.sum(sd * normal[met], axis=1) > 0.0

    die = mtype == MAT_DIELECTRIC
    if np.any(die):
        ir = sn.ir[mat[die]]
        ratio = np.where(front[die], F(1.0) / ir, ir).astype(F)
        dd = d_in[die]
        unit = (dd / np.sqrt(np.sum(dd * dd, axis=1, keepdims=True))
                ).astype(F)
        nd = normal[die]
        cos_theta = np.minimum(np.sum(-unit * nd, axis=1), F(1.0))
        sin_theta = np.sqrt(1.0 - cos_theta * cos_theta)
        cannot = ratio * sin_theta > 1.0
        u = rng.random(int(die.sum()), dtype=np.float32)
        do_reflect = cannot | (_reflectance(cos_theta, ratio) > u)
        direction[die] = np.where(do_reflect[:, None],
                                  _reflect(unit, nd),
                                  _refract(unit, nd, ratio))
        # attenuation stays (1, 1, 1); always scatters (material.h:45-59)
    return ok, atten, direction


# -------------------------------------------------------------- integrator

def _sky(d):
    """main.cu:34-36."""
    unit = d / np.sqrt(np.sum(d * d, axis=1, keepdims=True))
    t = (0.5 * (unit[:, 1] + 1.0)).astype(F)[:, None]
    return ((1.0 - t) * np.array([1.0, 1.0, 1.0], F)
            + t * np.array([0.5, 0.7, 1.0], F))


def trace(sn: SceneNp, o, d, max_depth: int, rng,
          t_min: float = 1e-3) -> np.ndarray:
    """rayTracing (main.cu:21-37): while (depth-- > 0) { miss -> break;
    scatter-false -> return black; atten *= next }. After the loop —
    whether by miss or depth exhaustion — sky(current dir) * atten.
    Vectorized with index compaction; radiance for scatter-false rays is
    already zero."""
    n = o.shape[0]
    radiance = np.zeros((n, 3), F)
    live = np.arange(n)
    atten = np.ones((n, 3), F)
    cur_o, cur_d = o.copy(), d.copy()

    for _ in range(max_depth):
        if live.size == 0:
            return radiance
        idx, t, valid = closest_hit(sn, cur_o[live], cur_d[live],
                                    t_min, INF)
        miss = live[~valid]
        radiance[miss] = _sky(cur_d[miss]) * atten[miss]
        live = live[valid]
        if live.size == 0:
            return radiance
        idx, t = idx[valid], t[valid]
        p, normal, front = _hit_normal(sn, idx, cur_o[live],
                                       cur_d[live], t)
        ok, a, sd = scatter(sn, idx, p, normal, front, cur_d[live], rng)
        atten[live] *= a
        cur_o[live] = p
        cur_d[live] = sd
        live = live[ok]           # scatter-false -> black (stays 0)

    # depth exhausted: the reference quirk — sky of the LAST SCATTERED
    # direction times the accumulated attenuation (main.cu:26,34-36)
    radiance[live] = _sky(cur_d[live]) * atten[live]
    return radiance


def render(scene: Scene, cam, width: int, height: int, spp: int,
           max_depth: int, seed: int = 0, chunk: int = 65536):
    """Converged oracle render. Returns (mean, var_of_mean): (H, W, 3)
    linear radiance (NOT gamma'd — compare against the repo renderer's
    linear output) and the per-pixel variance of that mean (sample variance
    / spp, for noise-scaled parity tolerances)."""
    sn = scene_to_np(scene)
    rng = np.random.default_rng(seed)
    n_pix = width * height
    acc = np.zeros((n_pix, 3), np.float64)
    acc2 = np.zeros((n_pix, 3), np.float64)
    rows, cols = np.divmod(np.arange(n_pix), width)
    rows = rows.astype(F)
    cols = cols.astype(F)
    w_inv, h_inv = F(1.0 / width), F(1.0 / height)
    for _ in range(spp):
        for lo in range(0, n_pix, chunk):
            sl = slice(lo, min(lo + chunk, n_pix))
            npx = sl.stop - sl.start
            # pixel jitter (main.cu:283-285)
            u = (cols[sl] + rng.random(npx, dtype=np.float32)) * w_inv
            v = (rows[sl] + rng.random(npx, dtype=np.float32)) * h_inv
            o, d = get_rays(cam, u, v, rng)
            rad = trace(sn, o, d, max_depth, rng)
            acc[sl] += rad
            acc2[sl] += rad.astype(np.float64) ** 2
    mean = acc / spp
    # variance of the MEAN: Var[x]/spp
    var = np.maximum(acc2 / spp - mean * mean, 0.0) / max(spp - 1, 1)
    return (mean.reshape(height, width, 3).astype(F),
            var.reshape(height, width, 3).astype(F))


def render_torch_linear(scene: Scene, cam, width: int, height: int,
                        spp: int, max_depth: int, seed: int = 0,
                        accel: str = "tensor", scene_name: str = "test",
                        device="cuda") -> np.ndarray:
    """The port renderer's LINEAR mean radiance (no gamma, the oracle's
    output space): ``render_sum`` over one chunk, averaged, on
    ``device``."""
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.render import renderer as renderer_mod

    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth, accel=accel,
                       ray_chunk=width * height, scene=scene_name)
    rows0, cols0 = renderer_mod.padded_pixel_grid(cfg, cfg.ray_chunk, device)
    acc, _ = renderer_mod.render_sum(scene.to(device), cam.to(device),
                                     prng.PRNGKey(seed), rows0, cols0, cfg,
                                     cfg.spp)
    n_pix = width * height
    return acc[:n_pix].cpu().numpy().reshape(height, width, 3) / spp


def compare_to_torch(scene: Scene, cam, width: int, height: int, spp: int,
                     max_depth: int, oracle_mean: np.ndarray, seed: int = 0,
                     scene_name: str = "test", accel: str = "tensor",
                     device="cuda") -> dict:
    """Self-calibrating parity statistics: the oracle-vs-port difference
    against the port-vs-port difference at matched spp (two renders at
    seeds seed + 1 and seed + 2). Under the null hypothesis (both estimate
    the same image with the same pixel filter) ``port_A - oracle`` and
    ``port_A - port_B`` are identically distributed, so no per-pixel
    variance model is needed. Returns quantile ratios; tests assert cross
    close to self."""
    a = render_torch_linear(scene, cam, width, height, spp, max_depth,
                            seed=seed + 1, scene_name=scene_name,
                            accel=accel, device=device)
    b = render_torch_linear(scene, cam, width, height, spp, max_depth,
                            seed=seed + 2, scene_name=scene_name,
                            accel=accel, device=device)
    d_cross = np.abs(a - oracle_mean)
    d_self = np.abs(a - b)
    q = lambda x, p: float(np.quantile(x, p))  # noqa: E731
    return {
        "torch_spp": spp,
        "mean_abs_cross": round(float(d_cross.mean()), 6),
        "mean_abs_self": round(float(d_self.mean()), 6),
        "p99_cross": round(q(d_cross, 0.99), 6),
        "p99_self": round(q(d_self, 0.99), 6),
        "mean_signed_diff": round(float((a - oracle_mean).mean()), 6),
        "mean_signed_self": round(float((a - b).mean()), 6),
    }


def main(argv=None):
    import argparse
    import json
    import time

    from pathtracer_tpu_torch.scene.worlds import get_world

    p = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.oracle",
        description="Render a scene with the NumPy oracle and (optionally) "
                    "compare against the port's renderer.")
    p.add_argument("--scene", default="test")
    p.add_argument("--width", type=int, default=200)
    p.add_argument("--height", type=int, default=112)
    p.add_argument("--spp", type=int, default=128)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compare", action="store_true",
                   help="also render with the port's renderer and report "
                        "noise-scaled agreement")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the scene and of the port's renders "
                        "(cpu: the plain twins, tests only)")
    p.add_argument("--out", default=None, help="PNG path for the oracle "
                                               "image (gamma'd)")
    args = p.parse_args(argv)

    scene, cam = get_world(args.scene, device=args.device)
    t0 = time.time()
    mean, _ = render(scene, cam, args.width, args.height, args.spp,
                     args.depth, seed=args.seed)
    dt = time.time() - t0
    out = {"scene": args.scene, "spp": args.spp, "depth": args.depth,
           "width": args.width, "height": args.height,
           "oracle_seconds": round(dt, 1),
           "mean_radiance": round(float(mean.mean()), 6)}
    if args.compare:
        out.update(compare_to_torch(scene, cam, args.width, args.height,
                                    args.spp, args.depth, mean,
                                    seed=args.seed, scene_name=args.scene,
                                    device=args.device))
    if args.out:
        from pathtracer_tpu_torch.io.png import write_png
        write_png(args.out, np.clip(mean, 0, 1) ** 0.5)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
