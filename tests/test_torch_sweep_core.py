"""The real-row ranges and the group split of the dense and window sweep
kernels, on the CPU through their plain twins.

- The ranges (``ClusterTables.ranges``, ``pallas_sweep.kernel_tables``)
  are contiguous and cover exactly the rows that hold a primitive.
- Each twin with ranges is bit-identical to the same twin over every row:
  the padding rows it skips can never hit (in the cluster tables their
  packed |c|^2 - r^2 overflows to inf, so the discriminant is NaN or -inf,
  for any ray; in the dense tables they are all-zero triangles, det == 0).
- The kernels' staged epilogue (a sphere's roots only where disc >= 0, a
  triangle's t only where its barycentric tests pass) gives the full
  epilogue's effective t bit for bit, special values included.
- A plain emulation of the kernels' split (G groups of primitives, each a
  strict-``<`` walk, merged by smaller t then smaller index; RT rays per
  thread with dead slots past the ragged end) returns exactly the twin's
  (t, best), ties included.

The kernels themselves are held against the twins on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch
from test_torch_march import _bounce_rays
from test_torch_rounds import _camera_rays, _tables, _window_case

from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
from pathtracer_tpu_torch.core import vec
from pathtracer_tpu_torch.core.camera import get_rays
from pathtracer_tpu_torch.ops import cluster_sweep as tsweep
from pathtracer_tpu_torch.ops import pallas_sweep as tpallas
from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
from pathtracer_tpu_torch.ops.tensor_sweep import (BIG, _epilogue, contract,
                                                   pack_sweep_tables,
                                                   ray_features, row_ranges)
from pathtracer_tpu_torch.presets import combined_scene, get_preset
from pathtracer_tpu_torch.scene.scene import SceneBuilder
from pathtracer_tpu_torch.scene.worlds import get_world

torch.set_num_threads(1)

T_MIN = 1e-3


def _full(ranges, width):
    """Ranges that sweep every row."""
    out = torch.zeros_like(ranges)
    out[:, 1] = width
    return out


@pytest.mark.parametrize("name,K", [("bunny", 64), ("bunny", 128),
                                    ("combined", 64), ("random", 128)])
def test_cluster_ranges_cover_the_real_rows(name, K):
    if name == "combined":
        scene, _ = combined_scene(device="cpu")
    else:
        scene, _ = get_world(name, device="cpu")
    ct = build_cluster_tables(scene, K=K)
    C_tot = ct.cols.shape[0]
    real = (ct.perm < scene.num_prims).view(C_tot, K)
    lo, hi = (x.numpy() for x in ct.ranges.unbind(1))
    assert ct.ranges.dtype == torch.int32 and ct.ranges.shape == (C_tot, 2)
    k = np.arange(K)
    covered = (k[None, :] >= lo[:, None]) & (k[None, :] < hi[:, None])
    np.testing.assert_array_equal(covered, real.numpy())
    # regular clusters start at row 0; the residual tile ends at row K
    assert (lo[:-1][hi[:-1] > 0] == 0).all()
    assert hi[-1] == K and 0 < K - lo[-1] <= 8
    assert int((hi - lo).sum()) == scene.num_prims


def test_row_ranges_rejects_gaps_and_allows_empty_rows():
    real = torch.tensor([[False, True, True, False], [False] * 4,
                         [True] * 4])
    assert row_ranges(real).tolist() == [[1, 3], [0, 0], [0, 4]]
    with pytest.raises(ValueError, match="not contiguous"):
        row_ranges(torch.tensor([[True, False, True, False]]))


def _dense_scene(name):
    if name == "cornell-full":
        scene, cam, _ = get_preset("cornell-full", device="cpu")
        return scene, cam
    return get_world(name, device="cpu")


@pytest.mark.parametrize("name,tile", [("test", 1024), ("triangle", 1024),
                                       ("triangle", 128),
                                       ("cornell-full", 1024)])
def test_dense_ranges_are_the_valid_prefix(name, tile):
    scene, _ = _dense_scene(name)
    tables = pack_sweep_tables(scene, tile=tile)
    ranges = tpallas.kernel_tables(tables)[2]
    n_valid = tables.valid_row.sum(dim=1)
    assert ranges[:, 0].eq(0).all()
    np.testing.assert_array_equal(ranges[:, 1].numpy(), n_valid.numpy())
    assert int(n_valid.sum()) == scene.num_prims


def _camera(cam, n, seed):
    u = torch.from_numpy(np.random.default_rng(seed).random(
        (4, n), dtype=np.float32))
    o, d, _ = get_rays(cam, u[0], u[1], u[2], u[3], torch.zeros(n))
    return o, d


def _dense_args(name, kind, n=700):
    """sweep arguments on the triangle world or cornell-full: camera rays
    (n, not a multiple of 128), or a cornell-full shadow wavefront."""
    scene, cam = _dense_scene(name)
    kt = tpallas.kernel_tables(pack_sweep_tables(scene,
                                                 tile=tpallas.DEF_PRIM_TILE))
    o, d = _camera(cam, n, 3)
    t_min = T_MIN
    if kind == "shadow":
        idx, t, valid = tpallas.pallas_closest(
            pack_sweep_tables(scene, tile=tpallas.DEF_PRIM_TILE), o, d, T_MIN)
        p = o + t[:, None] * d
        light = torch.from_numpy(np.random.default_rng(4).uniform(
            (200, 540, 200), (350, 548, 350), (n, 3)).astype(np.float32))
        o = p
        d = torch.where(valid[:, None], light - p, 0.0)
        t_min = K_SHADOW_T_MIN
    return tpallas.sweep_inputs(kt, o, d, t_min)


@pytest.mark.parametrize("name,kind", [("triangle", "camera"),
                                       ("cornell-full", "camera"),
                                       ("cornell-full", "shadow")])
def test_dense_twin_with_ranges_equals_full_sweep(name, kind):
    args = list(_dense_args(name, kind))
    ranges = args[4]
    got = tpallas.sweep_reference(*args)
    args[4] = _full(ranges, args[3].shape[1])
    ref = tpallas.sweep_reference(*args)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (got[1] >= 0).sum() > 50


def test_dense_twin_rejects_ranges_off_the_tile():
    args = list(_dense_args("triangle", "camera", n=128))
    for bad in ([[0, 1025]], [[-1, 10]], [[20, 10]]):
        args[4] = torch.tensor(bad, dtype=torch.int32)
        with pytest.raises(ValueError, match="leaves"):
            tpallas.sweep_reference(*args)


@pytest.fixture(scope="module")
def bunny():
    return _tables("bunny")


@pytest.mark.parametrize("kind", ["residual", "window", "last", "fallback",
                                  "allskip"])
@pytest.mark.parametrize("wave", ["camera", "bounce", "dead"])
def test_window_twin_with_ranges_equals_full_sweep(bunny, kind, wave):
    n = 384
    if wave == "camera":
        o, d = _camera_rays(bunny["jc"], n=n, seed=6)
    else:
        o, d = (x[:n] for x in _bounce_rays(7))
        o, d = o.copy(), d.copy()
        if wave == "dead":
            d[::5] = 0.0
            d[:128] = 0.0
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    tct = bunny["tct"]
    K = tct.K
    C_tot = tct.cols.shape[0]
    starts, skips, W = _window_case(kind, tct, ot, dt,
                                    np.random.default_rng(8))
    a = vec.dot(dt, dt)
    args = [ray_features(ot, dt), torch.where(a == 0.0, 1.0, a),
            torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(skips.astype(np.int32)), tct.cols,
            tct.is_sphere.view(C_tot, K), tct.ranges, K, W, T_MIN, 128]
    got = tsweep.window_reference(*args)
    args[6] = _full(tct.ranges, K)
    ref = tsweep.window_reference(*args)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_window_twin_rejects_ranges_off_the_cluster(bunny):
    tct = bunny["tct"]
    C_tot = tct.cols.shape[0]
    o, d = (torch.from_numpy(x) for x in _camera_rays(bunny["jc"], n=128))
    bad = tct.ranges.clone()
    bad[3, 1] = tct.K + 1
    with pytest.raises(ValueError, match="leaves"):
        tsweep.window_reference(
            ray_features(o, d), vec.dot(d, d),
            torch.tensor([0], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32), tct.cols,
            tct.is_sphere.view(C_tot, tct.K), bad, tct.K, 4, T_MIN, 128)


@pytest.mark.parametrize("scale", [1.0, 1e10, 1e30])
def test_padding_rows_never_hit(bunny, scale):
    """The inert padding rows of the cluster tables (radius-0 spheres at
    3e37) give no hit for random rays, origins up to 1e30 included."""
    tct = bunny["tct"]
    K = tct.K
    C_tot = tct.cols.shape[0]
    pad = (tct.perm >= bunny["ts"].num_prims).view(C_tot, K)
    rng = np.random.default_rng(int(np.log10(scale)))
    n = 256
    o = (rng.standard_normal((n, 3)) * scale).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:8] *= 1e-20          # tiny directions too
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    phi = ray_features(ot, dt)
    a = vec.dot(dt, dt)[:, None]
    n_pad = 0
    for c in torch.nonzero(pad.any(dim=1)).squeeze(1).tolist():
        S = contract(phi, tct.cols[c])
        sph = tct.is_sphere[c, 0] != 0
        t_eff = _epilogue(S[:, 0:K], S[:, K:2 * K], S[:, 2 * K:3 * K],
                          S[:, 3 * K:4 * K], a, sph, torch.ones_like(sph),
                          T_MIN, BIG)
        assert (t_eff[:, pad[c]] == BIG).all()
        assert sph[pad[c]].all()
        n_pad += int(pad[c].sum())
    assert n_pad >= K


def _staged_epilogue(B, C0, P2, P3, a2, is_sphere, t_min, t_max):
    """The kernels' epilogue as sweep_records forms it: a sphere's roots
    only where disc >= 0; a triangle's t only where det != 0, b1 > 0,
    b2 > 0 and b1 + b2 < 1. Effective t: the hit t, else BIG."""
    disc = B * B - a2 * C0
    gate_s = disc >= 0.0
    sqrt_d = torch.where(disc > 0.0, torch.sqrt(torch.where(disc > 0.0,
                                                            disc, 1.0)), 0.0)
    inv_a = 1.0 / a2
    root0 = (-B - sqrt_d) * inv_a
    root1 = (-B + sqrt_d) * inv_a
    ok0 = ~((root0 < t_min) | (t_max < root0))
    ok1 = ~((root1 < t_min) | (t_max < root1))
    t_s = torch.where(ok0, root0, root1)
    hit_s = gate_s & (ok0 | ok1)
    inv_det = 1.0 / torch.where(B == 0.0, 1.0, B)
    b1, b2 = P2 * inv_det, P3 * inv_det
    gate_t = ~((B == 0.0) | (b1 <= 0.0) | (b2 <= 0.0) | (b1 + b2 >= 1.0))
    t_t = C0 * inv_det
    hit_t = gate_t & ~((t_t <= t_min) | (t_t >= t_max))
    return torch.where(is_sphere, torch.where(hit_s, t_s, BIG),
                       torch.where(hit_t, t_t, BIG))


def test_staged_epilogue_equals_full_epilogue():
    """Forming a sphere's roots only where disc >= 0 and a triangle's t
    only where the barycentric tests pass gives the full epilogue's
    effective t bit for bit, on pair scalars that include 0, +-inf, NaN,
    denormals and values of every scale."""
    rng = np.random.default_rng(5)
    n = 200000
    special = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                          1e-38, 3e38, -3e38, 1.0, -1.0, 0.5])
    cols = []
    for _ in range(5):
        with np.errstate(over="ignore", under="ignore"):
            x = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 39, n))
            x = x.astype(np.float32)
        pick = rng.random(n) < 0.2
        x[pick] = rng.choice(special, pick.sum())
        cols.append(torch.from_numpy(x))
    B, C0, P2, P3, a = cols
    a = torch.where(torch.from_numpy(rng.random(n) < 0.9), torch.abs(a), a)
    sph = torch.from_numpy(rng.random(n) < 0.5)
    for t_min, t_max in ((1e-3, BIG), (1e-7, 1.0), (-1.0, 2.0)):
        full = _epilogue(B, C0, P2, P3, a, sph, torch.ones_like(sph), t_min,
                         t_max)
        staged = _staged_epilogue(B, C0, P2, P3, a, sph, t_min, t_max)
        np.testing.assert_array_equal(staged.numpy(), full.numpy())
        assert (full < BIG).sum() > 1000


def _split_sweep(t_eff, base, groups, rt, lanes=32):
    """Plain emulation of the kernels' split: rays in threads of ``rt``
    (``lanes`` threads per block, dead slots past the ragged end get
    BIG), each group of primitive indices (ascending) walked with a strict
    ``<``, then the groups merged in order: smaller t wins, on equal t the
    smaller index (an index of -1 as the largest unsigned value)."""
    R = t_eff.shape[0]
    per_block = rt * lanes
    R_pad = -(-R // per_block) * per_block
    t_pad = torch.cat([t_eff, t_eff.new_full((R_pad - R, t_eff.shape[1]),
                                             BIG)])
    bt = torch.full((R_pad,), BIG)
    bi = torch.full((R_pad,), -1, dtype=torch.int64)
    for idx in groups:
        if len(idx) == 0:
            continue
        sub = t_pad[:, idx]
        j = torch.argmin(sub, dim=1)
        gt = torch.gather(sub, 1, j[:, None])[:, 0]
        gi = torch.where(gt < BIG, base + idx[j], -1)
        un = lambda x: torch.where(x < 0, 2 ** 32 - 1, x)   # noqa: E731
        take = (gt < bt) | ((gt == bt) & (un(gi) < un(bi)))
        bt = torch.where(take, gt, bt)
        bi = torch.where(take, gi, bi)
    return bt[:R], bi[:R].to(torch.int32)


def _tie_scene():
    """One triangle at rows 0 and 5 (the same triangle twice), spheres
    between and after them."""
    b = SceneBuilder()
    m = b.add_lambertian((0.5, 0.5, 0.5))
    tri = ((-1, -1, 0), (1, -1, 0), (0, 1, 0))
    b.add_triangle(*tri, m)
    for i in range(4):
        b.add_sphere((3.0 * (i + 1), 0, -2), 0.5, m)
    b.add_triangle(*tri, m)
    for i in range(30):
        b.add_sphere((0.1 * i - 1.5, 0.2 * (i % 5) - 0.5, -4 - 0.1 * i),
                     0.4, m)
    return b.build(device="cpu")


@pytest.mark.parametrize("rt", [1, 2])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("scene_name", ["tie", "triangle"])
def test_group_split_gives_the_twins_result(scene_name, G, rt):
    if scene_name == "tie":
        scene = _tie_scene()
        rng = np.random.default_rng(G)
        n = 203
        o = np.zeros((n, 3), np.float32)
        o[:, 0:2] = rng.uniform(-0.6, 0.6, (n, 2))
        o[:, 2] = 3.0
        d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
        o, d = torch.from_numpy(o), torch.from_numpy(d)
    else:
        scene, cam = get_world("triangle", device="cpu")
        o, d = _camera(cam, 203, G)
    kt = tpallas.kernel_tables(pack_sweep_tables(scene, tile=1024))
    args = tpallas.sweep_inputs(kt, o, d, T_MIN)
    t_ref, b_ref = tpallas.sweep_reference(*args)
    phi, a, cols, is_sphere, ranges = args[:5]
    lo, hi = ranges[0].tolist()
    tile = is_sphere.shape[1]
    S = contract(phi, cols[0])
    t_eff = _epilogue(S[:, 0:tile], S[:, tile:2 * tile],
                      S[:, 2 * tile:3 * tile], S[:, 3 * tile:4 * tile],
                      a[:, None], is_sphere[0] != 0, True, T_MIN,
                      BIG)[:, lo:hi]
    n = hi - lo
    rng = np.random.default_rng(100 + G)
    cuts = np.sort(rng.choice(np.arange(1, n), G - 1, replace=False))
    splits = {
        # the kernels' split: group g takes every G-th staged primitive
        "interleaved": [torch.arange(g, n, G) for g in range(G)],
        # uneven contiguous sub-ranges, in descending order of group
        "uneven": [torch.from_numpy(x.astype(np.int64)) for x in
                   np.split(np.arange(n), cuts)][::-1]}
    for split in splits.values():
        t, b = _split_sweep(t_eff, lo, split, rt)
        np.testing.assert_array_equal(t.numpy(), t_ref.numpy())
        np.testing.assert_array_equal(b.numpy(), b_ref.numpy())
    if scene_name == "tie":
        hit_tri = (b_ref == 0)
        assert hit_tri.sum() > 20 and not (b_ref == 5).any()
