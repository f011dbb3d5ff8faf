"""The march's input preparation (``march_inputs``: cull, bin key, stop
gates, chunk orders, residual sweep) as its two CUDA kernels compute it,
held on the CPU against the plain twin ``march_inputs_reference``.

The kernels (``march_bin`` and ``march_order`` in
``csrc/cluster_march.cu``) rest on four invariants, each checked here on
the twin's own tensors:

- the bin key as int32 sorts to the int64 key's permutation;
- a lane's entries recomputed from its sorted ray equal the twin's
  permuted entry columns (a ray's cull depends on that ray alone);
- ranking each chunk's (entry, id) pairs, entries mapped to order-keeping
  ints, gives ``torch.sort(..., stable=True)``'s order, ties, negative
  entries and chunks that touch no box included;
- the residual winner as a first minimum over the tile's rows, a NaN
  first, is ``argmin`` / ``amin``.

``march_inputs`` on the CPU is the twin, field by field, on each named
wavefront. The kernels themselves are held against the twin on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py --prep``).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
from pathtracer_tpu_torch.core.camera import get_rays
from pathtracer_tpu_torch.ops import cluster_sweep as tsweep
from pathtracer_tpu_torch.ops.clusters import K_RES, build_cluster_tables
from pathtracer_tpu_torch.ops.tensor_sweep import BIG
from pathtracer_tpu_torch.presets import combined_scene
from pathtracer_tpu_torch.scene.worlds import get_world

torch.set_num_threads(1)

T_MIN = 1e-3
N = 512


def _f32(x):
    """A Python scalar as the float32 that torch casts it to."""
    return torch.tensor(x, dtype=torch.float32)


BIG_F, HALF_F = _f32(BIG), _f32(BIG * 0.5)


@pytest.fixture(scope="module")
def scenes():
    """The K=64 cluster tables and cameras of the two march cells' scenes:
    the bunny (its residual the ground sphere) and the combined room (its
    residual the room's walls, triangles)."""
    out = {}
    for name in ("bunny", "combined"):
        if name == "bunny":
            scene, cam = get_world("bunny", device="cpu")
        else:
            scene, cam = combined_scene(device="cpu")
        ct = build_cluster_tables(scene, K=64)
        assert int(ct.ranges[ct.C_reg, 1] - ct.ranges[ct.C_reg, 0]) > 0
        out[name] = SimpleNamespace(ct=ct, cam=cam)
    return out


def _camera(cam, n, seed):
    u = torch.from_numpy(np.random.default_rng(seed).random(
        (4, n), dtype=np.float32))
    o, d, _ = get_rays(cam, u[0], u[1], u[2], u[3], torch.zeros(n))
    return o, d


def _bounce(ct, n, seed):
    """Incoherent rays: origins inside the scene's cluster boxes' hull,
    random directions."""
    rng = np.random.default_rng(seed)
    lo = ct.cmin.amin(dim=0).numpy()
    hi = ct.cmax.amax(dim=0).numpy()
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _case(sc, case):
    """(o, d, kwargs of march_inputs) of one named wavefront."""
    ct = sc.ct
    if case == "sorted":
        o, d = _camera(sc.cam, N, 1)
        return o, d, {}
    if case == "unsorted":
        o, d = _bounce(ct, N, 2)
        return o, d, dict(sort_rays=False)
    if case == "extras":
        o, d = _bounce(ct, N, 3)
        alive = torch.from_numpy(np.random.default_rng(4).random(N) < 0.8)
        payload = torch.from_numpy(np.random.default_rng(5).random(
            N, dtype=np.float32))
        rid = torch.arange(N, dtype=torch.int32)
        return o, d, dict(active=alive, extras=(payload, rid))
    if case == "unaligned":
        o, d = _camera(sc.cam, 300, 6)
        return o, d, {}
    if case == "zero_dirs":
        o, d = _bounce(ct, N, 7)
        d[::5] = 0.0
        d[:128] = 0.0           # one chunk wholly dead
        d[130, 0] = -0.0        # a direction with zero components
        d[131, 1:] = 0.0
        return o, d, {}
    # the shadow query: segments from camera hits, near-zero t_min, t_max
    # 1, caller order; an unaligned count
    o, d = _camera(sc.cam, 400, 8)
    idx, t, valid = tsweep.cluster_march(ct, o, d, T_MIN)
    p = o + t[:, None] * d
    target = torch.from_numpy(np.random.default_rng(9).uniform(
        ct.cmin.amin(dim=0).numpy(), ct.cmax.amax(dim=0).numpy(),
        (400, 3)).astype(np.float32))
    seg = torch.where(valid[:, None], target - p, 0.0)
    if case == "shadow":
        return p, seg, dict(t_min=K_SHADOW_T_MIN, active=valid, t_max=1.0,
                            sort_rays=False)
    assert case == "shadow_sorted"
    return p, seg, dict(t_min=K_SHADOW_T_MIN, active=valid, t_max=1.0)


CASES = ["sorted", "unsorted", "extras", "unaligned", "zero_dirs", "shadow",
         "shadow_sorted"]


def _twin(ct, o, d, kw):
    kw = dict(kw)
    t_min = kw.pop("t_min", T_MIN)
    return tsweep.march_inputs_reference(ct, o, d, t_min, **kw)


def _ordered(x):
    """float32 -> int32 keeping the order of every value but NaN (-0 below
    +0); its own inverse on the int32 side."""
    i = x.view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _unordered(k):
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).view(torch.float32)


def _entries(o_l, d_l, act, ct, t_min):
    """Each lane's entry of each box, (R, C), by the kernels' operations:
    1 / d, (box - o) * inv, the running bounds, tn - (1e-4 |tn| + 1e-6)."""
    inv = 1.0 / d_l
    R, C = o_l.shape[0], ct.C_reg
    tn = torch.full((R, C), float(_f32(t_min)))
    tf = torch.full((R, C), float(BIG_F))
    for ax in range(3):
        lo = (ct.cmin[None, :, ax] - o_l[:, None, ax]) * inv[:, None, ax]
        hi = (ct.cmax[None, :, ax] - o_l[:, None, ax]) * inv[:, None, ax]
        swap = inv[:, None, ax] < 0.0
        near = torch.where(swap, hi, lo)
        far = torch.where(swap, lo, hi)
        tn = torch.where(near > tn, near, tn)
        tf = torch.where(far < tf, far, tf)
    e = tn - (_f32(1e-4) * torch.abs(tn) + _f32(1e-6))
    return torch.where((tf < tn) | ~act[:, None], BIG_F, e)


def _bin_key(e, C):
    """march_bin's int32 key: the first minimum entry's box and the last
    touched box, each as a walk over the boxes."""
    R = e.shape[0]
    e_min = torch.full((R,), float(BIG_F))
    kmin = torch.zeros(R, dtype=torch.int32)
    klast = torch.full((R,), -1, dtype=torch.int32)
    for c in range(C):
        better = e[:, c] < e_min
        e_min = torch.where(better, e[:, c], e_min)
        kmin = torch.where(better, c, kmin)
        klast = torch.where(e[:, c] < HALF_F, c, klast)
    return torch.where(klast >= 0, kmin * (C + 1) + klast,
                       C * (C + 2)).to(torch.int32)


def _rank_order(m):
    """Each row's (int key, id) pairs ranked ascending: (ids, keys) in that
    order, as march_order writes them."""
    n, C = m.shape
    c = torch.arange(C)
    before = ((m[:, None, :] < m[:, :, None])
              | ((m[:, None, :] == m[:, :, None]) & (c[None, :] < c[:, None])))
    rank = before.sum(dim=2)                          # (n, C): rank of c
    ids = torch.empty((n, C), dtype=torch.int32)
    ids.scatter_(1, rank, c.expand(n, C).to(torch.int32))
    return ids, torch.gather(m, 1, ids.long())


def _bits(x):
    """A tensor as integers of its bits (floats) or as it is, for equality
    to the bit; every NaN as one NaN (torch's CPU reductions return a NaN
    of their own, whatever NaN they met: its bits are no part of the
    result, which is only compared)."""
    if x.dtype == torch.float32:
        x = torch.where(torch.isnan(x), float("nan"), x)
        return x.contiguous().view(torch.int32)
    return x


def _assert_same(name, got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.equal(_bits(got), _bits(want)), name


@pytest.mark.parametrize("name", ["bunny", "combined"])
def test_int32_key_sorts_like_the_int64_key(scenes, name):
    """The twin's int64 bin key and the same key as int32 give one stable
    permutation; so does march_bin's walk, which equals the twin's key."""
    ct = scenes[name].ct
    o, d = _bounce(ct, 4 * N, 11)
    d[::7] = 0.0
    act = (d != 0.0).any(dim=1)
    entry = tsweep._cull_T(o, d, act, ct.cmin, ct.cmax, T_MIN)
    C = ct.C_reg
    touched = entry < BIG * 0.5
    kmin = torch.argmin(entry, dim=0)
    klast = C - 1 - torch.argmax(touched.flip(0).to(torch.uint8), dim=0)
    key64 = torch.where(touched.any(dim=0), kmin * (C + 1) + klast,
                        C * (C + 2))
    assert key64.dtype == torch.int64 and int(key64.max()) < 2 ** 31
    key32 = key64.to(torch.int32)
    assert torch.equal(_bin_key(entry.T, C), key32)
    assert len(torch.unique(key64)) < key64.numel() // 2   # many ties
    assert torch.equal(torch.sort(key32, stable=True).indices,
                       torch.sort(key64, stable=True).indices)


@pytest.mark.parametrize("name", ["bunny", "combined"])
@pytest.mark.parametrize("t_min", [T_MIN, K_SHADOW_T_MIN])
def test_entries_recomputed_from_sorted_rays_equal_permuted_columns(
        scenes, name, t_min):
    """A ray's cull depends on that ray alone: the entries of the sorted
    rays, recomputed, are the twin's entry columns permuted, bit for
    bit."""
    ct = scenes[name].ct
    o, d = _bounce(ct, 2 * N, 12)
    o[:32] = 0.5 * (ct.cmin[:32] + ct.cmax[:32])   # rays from inside boxes
    d[::9] = 0.0
    act = (d != 0.0).any(dim=1)
    entry = tsweep._cull_T(o, d, act, ct.cmin, ct.cmax, t_min)
    order = torch.from_numpy(np.random.default_rng(13).permutation(2 * N))
    recomputed = tsweep._cull_T(o[order], d[order], act[order], ct.cmin,
                                ct.cmax, t_min)
    _assert_same("entry", recomputed, entry[:, order])
    _assert_same("transcribed", _entries(o[order], d[order], act[order], ct,
                                         t_min).T.contiguous(),
                 entry[:, order].contiguous())
    # a ray that starts inside a box enters it at t_min, less the margin:
    # below 0 at the shadow query's near-zero t_min
    assert bool((entry < 0).any()) == (t_min == K_SHADOW_T_MIN)


@pytest.mark.parametrize("kind", ["ties", "untouched", "negative",
                                  "twin"])
def test_rank_order_equals_stable_segmented_sort(scenes, kind):
    """Ranking each chunk's (entry, id) pairs on order-keeping ints gives
    torch.sort(stable=True)'s ids and entries: tied entries, chunks whose
    lanes touch no box (every entry BIG), negative entries, and the
    twin's own chunk entries."""
    rng = np.random.default_rng(14)
    if kind == "ties":
        x = rng.integers(0, 4, (64, 57)).astype(np.float32) * 0.5
    elif kind == "untouched":
        x = rng.random((64, 57), dtype=np.float32)
        x[rng.random((64, 57)) < 0.7] = float(BIG_F)
        x[::3] = float(BIG_F)
    elif kind == "negative":
        x = (rng.random((64, 57), dtype=np.float32) - 0.5) * 1e-5
        x[:, 0:56:2] = x[:, 1:57:2]
    else:
        ct = scenes["bunny"].ct
        o, d = _camera(scenes["bunny"].cam, N, 15)
        act = (d != 0.0).any(dim=1)
        entry = tsweep._cull_T(o, d, act, ct.cmin, ct.cmax, T_MIN)
        x = entry.reshape(ct.C_reg, N // 128, 128).amin(dim=2).T.numpy()
    x = torch.from_numpy(np.ascontiguousarray(x))
    assert not bool(torch.isnan(x).any())
    want_e, want_i = torch.sort(x, dim=1, stable=True)
    ids, keys = _rank_order(_ordered(x))
    _assert_same("ids", ids, want_i.to(torch.int32))
    _assert_same("ents", _unordered(keys), want_e)
    # the int keys keep the order of the floats, negatives included
    flat = torch.sort(x.reshape(-1)).values
    assert bool((_ordered(flat)[1:] >= _ordered(flat)[:-1]).all())


def test_residual_first_minimum_takes_nan_first():
    """The residual's winner walk (strict <, a NaN taken first) is torch's
    argmin / amin over the rows, NaN and ties included."""
    rng = np.random.default_rng(16)
    t = rng.integers(0, 3, (K_RES, 4096)).astype(np.float32)
    t[rng.random(t.shape) < 0.05] = np.nan
    t[:, :64] = float(BIG_F)
    t = torch.from_numpy(t)
    best, best_j = t[0], torch.zeros(t.shape[1], dtype=torch.int64)
    for j in range(1, K_RES):
        take = ~torch.isnan(best) & (torch.isnan(t[j]) | (t[j] < best))
        best = torch.where(take, t[j], best)
        best_j = torch.where(take, j, best_j)
    assert torch.equal(best_j, torch.argmin(t, dim=0))
    _assert_same("amin", best, torch.amin(t, dim=0))


@pytest.mark.parametrize("name", ["bunny", "combined"])
@pytest.mark.parametrize("case", CASES)
def test_cpu_march_inputs_is_the_twin(scenes, name, case):
    """On the CPU march_inputs returns the twin's dict, every field to the
    bit, and launches no kernel: sorted and caller order, extras, an
    unaligned wavefront, zero directions and the shadow query's t_max 1."""
    sc = scenes[name]
    o, d, kw = _case(sc, case)
    want = _twin(sc.ct, o, d, kw)
    kw = dict(kw)
    t_min = kw.pop("t_min", T_MIN)
    before = tsweep.MARCH_PREP_LAUNCHES
    got = tsweep.march_inputs(sc.ct, o, d, t_min, **kw)
    assert tsweep.MARCH_PREP_LAUNCHES == before
    for k in ("o", "d", "active", "active0", "rid", "t_res", "b_res"):
        _assert_same(k, got[k], want[k])
    for g, w in zip(got["args"][:5], want["args"][:5], strict=True):
        _assert_same("args", g, w)
    if want["extras"] is None:
        assert got["extras"] is None
    else:
        for g, w in zip(got["extras"], want["extras"], strict=True):
            _assert_same("extras", g, w)
    # the case exercises what it names
    gate = want["args"][2]
    assert bool(want["active"].any())
    if case == "zero_dirs":
        assert not bool(want["active0"][:128].any())
    if case.startswith("shadow"):
        assert bool((gate[want["active"]] <= 1.0).all())


@pytest.mark.parametrize("plan,takes", [
    (dict(), True), (dict(cull2=False, sup=1), True),
    (dict(cull2=True), False), (dict(sup=4), False),
    (dict(device="cpu"), False),
    (dict(C_reg=tsweep.CULL2_CLUSTERS + 1, cull2=False), False),
    (dict(C_reg=tsweep.CULL2_CLUSTERS, cull2=False), True),
    (dict(C_reg=tsweep.CULL2_CLUSTERS), False)])
def test_dispatch_follows_the_observed_inputs(monkeypatch, plan, takes):
    """The kernels take CUDA rays under the flat cull plan (no cull2, sup
    1, at most CULL2_CLUSTERS clusters); every other input, the default
    cull2 plan of 2,048 clusters among them, goes to the twin with its
    plan."""
    plan = dict(plan)
    C_reg = plan.pop("C_reg", 57)
    dev = torch.device(plan.pop("device", "cuda"))
    ray = SimpleNamespace(device=dev)
    calls = []
    monkeypatch.setattr(tsweep, "_march_inputs_cuda",
                        lambda *a, **k: calls.append("kernels"))
    monkeypatch.setattr(tsweep, "march_inputs_reference",
                        lambda *a, **k: calls.append(
                            ("twin", k["cull2"], k["sup"])))
    tsweep.march_inputs(SimpleNamespace(C_reg=C_reg), ray, ray, T_MIN,
                        **plan)
    if takes:
        assert calls == ["kernels"]
    else:
        assert len(calls) == 1 and calls[0][0] == "twin"
        assert calls[0][1:] == tsweep.cull_plan(C_reg, plan.get("cull2"),
                                                plan.get("sup"))
