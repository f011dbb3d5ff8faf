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
import inspect

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


# --- the march (cluster_march.cu): real-row ranges and an exact split ---


@pytest.fixture(scope="module")
def bunny64():
    """The bunny's K=64 cluster tables (the main path's) and its camera."""
    scene, cam = get_world("bunny", device="cpu")
    return dict(ct=build_cluster_tables(scene, K=64), cam=cam)


def _march_masked(phi, a, gate, ids, ents, cols, is_sphere, valid_row,
                  ctype, K, t_min, t_max, ray_tile):
    """The march twin as it was before it took ranges: every row of each
    cluster swept under its ``valid_row`` mask, primitives typed by the
    cluster's ``ctype`` (1 all-sphere, 2 all-triangle, 0 by row)."""
    n_chunks, n_slots = ids.shape
    P = phi.view(n_chunks, ray_tile, -1)
    A = a.view(n_chunks, ray_tile)
    G = gate.view(n_chunks, ray_tile)
    t_acc = torch.full((n_chunks, ray_tile), BIG)
    b_acc = torch.full((n_chunks, ray_tile), -1, dtype=torch.int32)
    slots = torch.zeros(n_chunks, dtype=torch.int32)
    marching = torch.ones(n_chunks, dtype=torch.bool)
    for j in range(n_slots):
        m = torch.amax(torch.minimum(t_acc, G), dim=1)
        marching = marching & (m > ents[:, j])
        live = torch.nonzero(marching).squeeze(1)
        if live.numel() == 0:
            break
        slots += marching.to(torch.int32)
        c = ids[live, j].long()
        S = contract(P[live], cols[c])
        ct = ctype[c][:, None, None]
        sph = (ct == 1) | ((ct == 0) & (is_sphere[c][:, None, :] != 0))
        t_eff = _epilogue(S[..., 0:K], S[..., K:2 * K], S[..., 2 * K:3 * K],
                          S[..., 3 * K:4 * K], A[live][:, :, None], sph,
                          valid_row[c][:, None, :] != 0, t_min, t_max)
        local_j = torch.argmin(t_eff, dim=2)
        local_t = torch.amin(t_eff, dim=2)
        better = local_t < t_acc[live]
        glob = (c[:, None] * K + local_j).to(torch.int32)
        t_acc[live] = torch.where(better, local_t, t_acc[live])
        b_acc[live] = torch.where(better, glob, b_acc[live])
    return t_acc.reshape(-1), b_acc.reshape(-1), slots


def _march_case(ct, cam, wave, n=512):
    """march_inputs of one wavefront on the K=64 bunny: camera rays, a
    bounce-like wavefront, the same with dead lanes (one chunk all dead),
    or NEE shadow segments from the camera hits to points above the bunny
    (t_min K_SHADOW_T_MIN, t_max 1, caller order)."""
    if wave == "camera":
        o, d = _camera(cam, n, 11)
        return tsweep.march_inputs(ct, o, d, T_MIN)
    if wave == "shadow":
        o, d = _camera(cam, n, 12)
        idx, t, valid = tsweep.cluster_march(ct, o, d, T_MIN)
        p = o + t[:, None] * d
        light = torch.from_numpy(np.random.default_rng(13).uniform(
            (-6, 2, -6), (6, 12, 6), (n, 3)).astype(np.float32))
        seg = torch.where(valid[:, None], light - p, 0.0)
        return tsweep.march_inputs(ct, p, seg, K_SHADOW_T_MIN, active=valid,
                                   t_max=1.0, sort_rays=False)
    o, d = (x[:n].copy() for x in _bounce_rays(7))
    if wave == "dead":
        d[::5] = 0.0
        d[:128] = 0.0
    return tsweep.march_inputs(ct, torch.from_numpy(o), torch.from_numpy(d),
                               T_MIN)


@pytest.mark.parametrize("wave", ["camera", "bounce", "dead", "shadow"])
def test_march_twin_with_ranges_equals_masked_sweep(bunny64, wave):
    """The twin over each cluster's real rows, primitives typed by their
    own rows, gives the (t, best, slots) of the full masked sweep typed
    by cluster."""
    ct = bunny64["ct"]
    q = _march_case(ct, bunny64["cam"], wave)
    args = q["args"]
    got = tsweep.march_reference(*args)
    C_tot = ct.cols.shape[0]
    names = list(inspect.signature(tsweep.march_reference).parameters)
    kw = dict(zip(names, args))
    del kw["ranges"]
    ref = _march_masked(**kw, valid_row=ct.valid_row.view(C_tot, ct.K),
                        ctype=ct.ctype)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert int(got[2].sum()) > 0
    if wave != "dead":
        assert (got[1] >= 0).sum() > 10
    if wave == "shadow":
        assert (got[0][got[1] >= 0] < 1.0).all()


def test_march_twin_rejects_ranges_off_the_cluster(bunny64):
    ct = bunny64["ct"]
    args = list(_march_case(ct, bunny64["cam"], "camera", n=128)["args"])
    for bad in ((3, 1, ct.K + 1), (0, 0, -1), (5, 0, 40)):
        r = ct.ranges.clone()
        r[bad[0], bad[1]] = bad[2]
        if bad[0] == 5:
            r[5] = torch.tensor([40, 30])
        args[7] = r
        with pytest.raises(ValueError, match="leaves"):
            tsweep.march_reference(*args)


def _unsigned(x):
    return torch.where(x < 0, 2 ** 32 - 1, x.long())


def _march_split(phi, a, gate, ids, ents, cols, is_sphere, ranges, K, t_min,
                 t_max, ray_tile, groups, end_merge=False):
    """Plain emulation of the march kernel's split: per slot, group g walks
    the staged rows lo + g, lo + g + G, ... of the cluster with a strict
    ``<``; the groups' results are merged by smaller t, then smaller index
    (the cluster's first minimum) and folded into the running best with a
    strict ``<``, slot by slot; the stop test reads the folded bests.
    ``end_merge`` instead merges every slot's result into the running best
    by (t, index), the rule that is wrong across slots."""
    n_chunks, n_slots = ids.shape
    P = phi.view(n_chunks, ray_tile, -1)
    A = a.view(n_chunks, ray_tile)
    Gt = gate.view(n_chunks, ray_tile)
    t_run = torch.full((n_chunks, ray_tile), BIG)
    i_run = torch.full((n_chunks, ray_tile), -1, dtype=torch.int64)
    slots = torch.zeros(n_chunks, dtype=torch.int32)
    marching = torch.ones(n_chunks, dtype=torch.bool)
    k = torch.arange(K)
    for j in range(n_slots):
        m = torch.amax(torch.minimum(t_run, Gt), dim=1)
        marching = marching & (m > ents[:, j])
        live = torch.nonzero(marching).squeeze(1)
        if live.numel() == 0:
            break
        slots += marching.to(torch.int32)
        c = ids[live, j].long()
        lo, hi = ranges[c, 0:1].long(), ranges[c, 1:2].long()
        swept = (k[None, :] >= lo) & (k[None, :] < hi)          # (L, K)
        S = contract(P[live], cols[c])
        t_eff = _epilogue(S[..., 0:K], S[..., K:2 * K], S[..., 2 * K:3 * K],
                          S[..., 3 * K:4 * K], A[live][:, :, None],
                          is_sphere[c][:, None, :] != 0, swept[:, None, :],
                          t_min, t_max)                       # (L, T, K)
        bt = torch.full(t_eff.shape[:2], BIG)
        bi = torch.full(t_eff.shape[:2], -1, dtype=torch.int64)
        for g in range(groups):
            mine = swept & ((k[None, :] - lo) % groups == g)
            tg = torch.where(mine[:, None, :], t_eff, BIG)
            jg = torch.argmin(tg, dim=2)
            tgm = torch.amin(tg, dim=2)
            ig = torch.where(tgm < BIG, c[:, None] * K + jg, -1)
            take = (tgm < bt) | ((tgm == bt) & (_unsigned(ig) <
                                                _unsigned(bi)))
            bt = torch.where(take, tgm, bt)
            bi = torch.where(take, ig, bi)
        t_prev, i_prev = t_run[live], i_run[live]
        take = bt < t_prev
        if end_merge:
            take = take | ((bt == t_prev) & (_unsigned(bi) <
                                             _unsigned(i_prev)))
        t_run[live] = torch.where(take, bt, t_prev)
        i_run[live] = torch.where(take, bi, i_prev)
    return (t_run.reshape(-1), i_run.reshape(-1).to(torch.int32), slots)


def _cross_slot_tie():
    """march arguments in which each chunk visits two clusters that hold
    the same primitives, the higher-indexed one first: the tie scene's K=8
    tables with the cluster of its first triangle copied into another, and
    rays that all meet that triangle at t ~ 3, bit-equal in both copies."""
    scene = _tie_scene()
    ct = build_cluster_tables(scene, K=8)
    K, C_tot = ct.K, ct.cols.shape[0]
    row = int(torch.nonzero(ct.perm == 0)[0, 0])
    c_a = row // K
    c_b = c_a + 1 if c_a + 1 < ct.C_reg else c_a - 1
    cols, sph = ct.cols.clone(), ct.is_sphere.view(C_tot, K).clone()
    ranges = ct.ranges.clone()
    cols[c_b], sph[c_b], ranges[c_b] = cols[c_a], sph[c_a], ranges[c_a]
    n, ray_tile = 256, 128
    rng = np.random.default_rng(21)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-0.3, 0.3, n)    # inside the triangle
    o[:, 1] = rng.uniform(-0.5, 0.2, n)
    o[:, 2] = 3.0
    o, d = torch.from_numpy(o), torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    n_chunks = n // ray_tile
    hi_c, lo_c = max(c_a, c_b), min(c_a, c_b)
    ids = torch.tensor([[hi_c, lo_c, 0]] * n_chunks, dtype=torch.int32)
    ents = torch.tensor([[0.0, 0.0, BIG]] * n_chunks)
    gate = torch.full((n,), 10.0)
    args = (ray_features(o, d), vec.dot(d, d), gate, ids, ents, cols, sph,
            ranges, K, T_MIN, BIG, ray_tile)
    return args, hi_c, lo_c, row % K


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["camera", "bounce", "shadow", "tie"])
def test_march_group_split_gives_the_twins_result(bunny64, case, G):
    if case == "tie":
        args, hi_c, lo_c, k = _cross_slot_tie()
    else:
        args = _march_case(bunny64["ct"], bunny64["cam"], case, n=384)[
            "args"]
    ref = tsweep.march_reference(*args)
    got = _march_split(*args, groups=G)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    if case == "tie":
        K = args[8]
        # both slots march, the earlier (higher-indexed) cluster wins, and
        # merging the slots by (t, index) would pick the later one
        assert (ref[2] == 2).all()
        assert ((ref[0] - 3.0).abs() < 1e-5).all()
        assert (ref[1] == hi_c * K + k).all()
        wrong = _march_split(*args, groups=G, end_merge=True)
        assert (wrong[1] == lo_c * K + k).all()
