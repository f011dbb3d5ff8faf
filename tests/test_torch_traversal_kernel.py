"""The control flow of the traversal kernel (``csrc/bvh_traverse.cu``) on
the CPU, and the wrapper's dispatch (``ops/traversal.py``).

The kernel cannot run here, so :func:`_kernel_ray` transcribes its per-ray
loop in numpy, float32 throughout: one ray at a time, to the done row or
the step cap, testing a leaf's primitive only where its box is hit and
keeping it only where t < t_best. It must give the plain twin
(``traverse_reference``, the wavefront loop in lockstep) to the bit: the
winner, t and the valid flag, on the worlds of
``test_torch_lbvh.py::test_traverse_matches_jax_and_brute_force``, on
axis-aligned rays and rays that start inside a box, under step caps, and
for the shadow query's t_min. ``tests/test_torch_cuda.py`` holds the kernel
itself to the twin on the card.
"""
import functools

import numpy as np
import pytest
import torch

from pathtracer_tpu.accel.lbvh import build_lbvh as jbuild
from pathtracer_tpu.ops import traversal as jtraversal
from pathtracer_tpu_torch.accel.lbvh import build_lbvh
from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
from pathtracer_tpu_torch.ops import _cuda_build, intersect, traversal
from test_torch_lbvh import T_MIN, WORLDS, _port, _rays

torch.set_num_threads(1)

F = np.float32
ZERO, ONE = F(0.0), F(1.0)
SPHERE = 1   # scene/scene.py's PRIM_SPHERE


def _sqrt(x):
    """float32 sqrt as the twin takes it. The kernel and the twin on the
    card take IEEE sqrt; torch's CPU sqrt is not correctly rounded
    everywhere (sqrt(137227.796875) gives 370.44268798828125, where numpy
    gives the rounded 370.44272), and this file checks control flow, not
    that rounding."""
    return F(torch.sqrt(torch.tensor([x], dtype=torch.float32)).item())


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _box_hit(o, inv, bmin, bmax, t_min, t_max):
    tmin_r, tmax_r = t_min, t_max
    for a in range(3):
        t0 = (bmin[a] - o[a]) * inv[a]
        t1 = (bmax[a] - o[a]) * inv[a]
        swap = inv[a] < ZERO
        lo, hi = (t1, t0) if swap else (t0, t1)
        tmin_r = lo if lo > tmin_r else tmin_r
        tmax_r = hi if hi < tmax_r else tmax_r
    return not (tmax_r < tmin_r)


def _sphere(o, d, c, radius, t_min, t_max):
    oc = [o[a] - c[a] for a in range(3)]
    a = _dot(d, d)
    half_b = _dot(oc, d)
    cc = _dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * cc
    sqrt_d = _sqrt(disc) if disc > ZERO else ZERO
    inv_a = ONE / a
    root0 = (-half_b - sqrt_d) * inv_a
    root1 = (-half_b + sqrt_d) * inv_a
    ok0 = not (root0 < t_min or t_max < root0)
    ok1 = not (root1 < t_min or t_max < root1)
    return disc >= ZERO and (ok0 or ok1), root0 if ok0 else root1


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _triangle(o, d, v0, e1, e2, t_min, t_max):
    s1 = _cross(d, e2)
    det = _dot(s1, e1)
    inv_det = ONE / (ONE if det == ZERO else det)
    s = [o[a] - v0[a] for a in range(3)]
    s2 = _cross(s, e1)
    t = _dot(s2, e2) * inv_det
    b1 = _dot(s1, s) * inv_det
    b2 = _dot(s2, d) * inv_det
    miss = (det == ZERO or b1 >= ONE or b1 <= ZERO or b2 >= ONE
            or b2 <= ZERO or b1 + b2 <= ZERO or b1 + b2 >= ONE
            or t <= t_min or t >= t_max)
    return not miss, t


def _kernel_ray(rows, links, done, o, d, t_min, t_max, max_steps):
    """The kernel's loop for one ray: (winner, t, valid)."""
    inv = [ONE / d[a] for a in range(3)]
    ptr, t_best, best, steps = 0, t_max, -1, 0
    while ptr != done and steps < max_steps:
        f = rows[ptr]
        left, escape, ptype, pid = links[ptr]
        hit_box = _box_hit(o, inv, f[0:3], f[3:6], t_min, t_best)
        is_leaf = ptype > 0
        if hit_box and is_leaf:
            if ptype == SPHERE:
                hit, t = _sphere(o, d, f[6:9], f[15], t_min, t_best)
            else:
                hit, t = _triangle(o, d, f[6:9], f[9:12], f[12:15], t_min,
                                   t_best)
            if hit and t < t_best:
                t_best, best = t, pid
        ptr = left if hit_box and not is_leaf else escape
        steps += 1
    return (best if best >= 0 else 0), t_best, best >= 0


def _kernel_loop(nodes, o, d, t_min, t_max, max_steps=0):
    """:func:`_kernel_ray` over every ray, as the kernel's outputs."""
    if max_steps <= 0:
        max_steps = 4 * nodes.fdata.shape[0]
    rows = [[F(x) for x in row] for row in nodes.fdata.numpy()]
    links = nodes.idata.tolist()
    out = []
    with np.errstate(all="ignore"):
        for oi, di in zip(o.astype(np.float32), d.astype(np.float32)):
            out.append(_kernel_ray(rows, links, nodes.done, list(oi),
                                   list(di), F(t_min), F(t_max), max_steps))
    idx, t, valid = zip(*out)
    return (np.array(idx, np.int64), np.array(t, np.float32),
            np.array(valid, bool))


@functools.lru_cache(maxsize=None)
def _world(name):
    js = WORLDS[name]()
    scene = _port(js)
    return js, scene, traversal.pack_fat_nodes(scene, build_lbvh(scene))


def _assert_bit_equal(got, want):
    gi, gt, gv = got
    wi, wt, wv = (x.numpy() for x in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gt.view(np.int32), wt.view(np.int32))


def _inside_and_axis_rays(nodes, n, rng):
    """Rays from the centres of random node boxes (inside them) in random
    directions, and axis-aligned rays whose origin lies on a box's slab
    plane on the zero axis, where (bmin - o) * (1 / 0) is NaN; signed zeros
    of both signs."""
    f = nodes.fdata.numpy()[:nodes.done]
    pick = rng.integers(0, nodes.done, n)
    bmin, bmax = f[pick, 0:3], f[pick, 3:6]
    o = (0.5 * (bmin + bmax)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    half = n // 2
    axis = rng.integers(0, 3, half)
    rows = np.arange(half)
    d[rows, axis] = np.where(rows % 2, 0.0, -0.0).astype(np.float32)
    on = rows % 4 < 2
    o[rows[on], axis[on]] = np.where(rows[on] % 8 < 4, bmin[rows[on],
                                     axis[on]], bmax[rows[on], axis[on]])
    d[half:half + n // 8, :2] = 0.0          # along z only
    return o, d


def _shadow_rays(nodes, o, d, rng):
    """Unnormalised segments from the camera rays' first hits (through the
    twin) to random points: the shadow query's rays, at its t_min."""
    _, t, valid = traversal.traverse_reference(
        nodes, torch.from_numpy(o), torch.from_numpy(d), T_MIN,
        intersect.BIG_T)
    t = np.where(valid.numpy(), t.numpy(), 1.0).astype(np.float32)
    p = (o + t[:, None] * d).astype(np.float32)
    target = rng.normal(0, 3, p.shape).astype(np.float32)
    target[:, 1] = np.abs(target[:, 1]) + 2.0
    return p, (target - p).astype(np.float32)


WORLD_NAMES = ["small40", "duplicate centres", "test", "bunny"]
N_RAYS = {"small40": 256, "duplicate centres": 128, "test": 256,
          "bunny": 96}


@pytest.mark.parametrize("max_steps", [1, 7, 0])
@pytest.mark.parametrize("world", WORLD_NAMES)
def test_kernel_loop_matches_twin(world, max_steps):
    """The worlds and rays of the JAX parity test, under the caps 1 and 7
    and the default (4 times the rows)."""
    js, _, nodes = _world(world)
    o, d = _rays(world, js, N_RAYS[world], np.random.default_rng(3))
    want = traversal.traverse_reference(nodes, torch.from_numpy(o),
                                        torch.from_numpy(d), T_MIN,
                                        intersect.BIG_T, max_steps)
    got = _kernel_loop(nodes, o, d, T_MIN, intersect.BIG_T, max_steps)
    _assert_bit_equal(got, want)
    if max_steps == 0:
        assert got[2].any()
    if max_steps == 1:
        assert not got[2].any() or nodes.done == 1


@pytest.mark.parametrize("world", WORLD_NAMES)
def test_kernel_loop_matches_twin_on_shadow_segments(world):
    """The shadow query's t_min (K_SHADOW_T_MIN) on segments that start
    on a surface: self-hits at t near 0 are decided by it."""
    js, _, nodes = _world(world)
    rng = np.random.default_rng(4)
    o, d = _shadow_rays(nodes, *_rays(world, js, N_RAYS[world], rng), rng)
    want = traversal.traverse_reference(nodes, torch.from_numpy(o),
                                        torch.from_numpy(d), K_SHADOW_T_MIN,
                                        intersect.BIG_T)
    got = _kernel_loop(nodes, o, d, K_SHADOW_T_MIN, intersect.BIG_T)
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("max_steps", [7, 0])
@pytest.mark.parametrize("world", ["small40", "test"])
def test_kernel_loop_matches_twin_inside_boxes_and_on_axes(world, max_steps):
    _, _, nodes = _world(world)
    o, d = _inside_and_axis_rays(nodes, 256, np.random.default_rng(6))
    want = traversal.traverse_reference(nodes, torch.from_numpy(o),
                                        torch.from_numpy(d), T_MIN,
                                        intersect.BIG_T, max_steps)
    got = _kernel_loop(nodes, o, d, T_MIN, intersect.BIG_T, max_steps)
    _assert_bit_equal(got, want)
    if max_steps == 0:
        assert got[2].any()


@pytest.mark.parametrize("world", WORLD_NAMES + ["one prim"])
def test_links_equal_idata(world):
    """The one link table, ``idata``, is the int32 table the kernel reads:
    contiguous, and the JAX package's ``pack_fat_nodes`` table to the
    value and dtype, the done row included."""
    js, _, nodes = _world(world)
    want = np.asarray(jtraversal.pack_fat_nodes(js, jbuild(js)).idata)
    assert nodes.idata.dtype == torch.int32 and nodes.idata.is_contiguous()
    assert want.dtype == np.int32
    np.testing.assert_array_equal(nodes.idata.numpy(), want)
    assert nodes.idata[nodes.done].tolist() == [nodes.done, nodes.done, 0, 0]


def test_cpu_tensors_take_the_twin(monkeypatch):
    """On CPU tensors ``traverse`` and the route's query give the twin's
    bits, build no kernel and count no launch."""
    def no_build(*args, **kw):
        raise AssertionError("a CPU query tried to build a kernel")
    monkeypatch.setattr(_cuda_build, "load", no_build)
    js, scene, nodes = _world("test")
    o, d = (torch.from_numpy(x) for x in _rays(
        "test", js, 64, np.random.default_rng(9)))
    before = traversal.TRAVERSE_LAUNCHES
    want = traversal.traverse_reference(nodes, o, d, T_MIN, intersect.BIG_T)
    for got in (traversal.traverse(nodes, o, d, T_MIN, intersect.BIG_T),
                traversal.make_bvh_closest_hit(scene, build_lbvh(scene),
                                               T_MIN)(o, d)):
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert traversal.TRAVERSE_LAUNCHES == before
    assert [x.dtype for x in want] == [torch.int64, torch.float32,
                                       torch.bool]


def test_other_devices_are_refused():
    _, _, nodes = _world("small40")
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no BVH traversal"):
        traversal.traverse(nodes, o, o, T_MIN, intersect.BIG_T)
