"""Large scenes in the port against the JAX reference: the subdivided bunny
(``scene/bunny.subdivide_faces``, ``bunny_world(subdivide=k)``), the cull
helpers of the two-level cull (``_cull_T(with_exit=True)``,
``_chunk_interval_cull``), the automatic cull2 switch, a subdivided render
under both culls, and the scaling tool.

Tolerances: the subdivision is the reference's numpy code, bit for bit.
The cull helpers equal the reference's eager (op-by-op) results bit for
bit: the same float32 operations in the same order per element (no XLA
fusion is involved when the reference runs eagerly). The render under
cull2 equals the flat-cull render within 1e-6 on every channel: the plan
changes only the march's cluster order, so winners may differ only at
bit-equal t ties.
"""
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_march import N, T_MIN, _camera_rays

from pathtracer_tpu.ops import cluster_sweep as jsweep
from pathtracer_tpu.ops import clusters as jclusters
from pathtracer_tpu.scene import bunny as jbunny
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.io.obj import load_obj
from pathtracer_tpu_torch.ops import cluster_sweep as tsweep
from pathtracer_tpu_torch.ops import clusters as tclusters
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import bunny as tbunny
from pathtracer_tpu_torch.tools import bench_dense_routes, bench_prim_scaling

torch.set_num_threads(1)

ASSET_FACES = 3616


@pytest.mark.parametrize("level", [1, 2])
def test_subdivide_faces_matches_jax(level):
    verts, faces = load_obj(tbunny.ASSET_OBJ)
    verts = verts * 20.0
    tv, tf = tbunny.subdivide_faces(verts, faces, level)
    jv, jf = jbunny.subdivide_faces(verts, faces, level)
    assert tv.dtype == jv.dtype == np.float32
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.shape == (ASSET_FACES * 4 ** level, 3)
    assert tbunny.subdivide_faces(verts, faces, 0)[0] is verts


def test_subdivided_bunny_world_matches_jax(monkeypatch):
    """``bunny_world(subdivide=1)``: every scene field equals the
    reference's bit for bit (subdivision after the scale, before the
    centring), 14,467 prims with the vendored asset."""
    monkeypatch.setenv("PT_BUNNY_OBJ", tbunny.ASSET_OBJ)
    js, jc = jbunny.bunny_world(obj_path=tbunny.ASSET_OBJ, subdivide=1)
    ts, tc = tbunny.bunny_world(obj_path=tbunny.ASSET_OBJ, subdivide=1,
                                device="cpu")
    assert ts.num_prims == js.num_prims == ASSET_FACES * 4 + 3
    for field in js._fields:
        a = np.asarray(getattr(js, field))
        b = getattr(ts, field).numpy()
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    for field in jc._fields:
        np.testing.assert_array_equal(getattr(tc, field).numpy(),
                                      np.asarray(getattr(jc, field)))


def _rays(kind, jc):
    if kind == "camera":
        o, d = _camera_rays(jc)
        return np.array(o), np.array(d), np.ones(N, bool)
    rng = np.random.default_rng(3)
    o = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d[::5] = 0.0
    # an axis-parallel direction: its interval spans zero in a chunk
    d[1] = (0.0, 0.0, -1.0)
    return o, d, np.any(d != 0.0, axis=1)


@pytest.fixture(scope="module")
def bunny():
    js, jc = jworlds.get_world("bunny")
    jct = jclusters.build_cluster_tables(js, K=64)
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    tct = tclusters.build_cluster_tables(ts, K=64)
    np.testing.assert_array_equal(tct.cmin.numpy(), np.asarray(jct.cmin))
    np.testing.assert_array_equal(tct.cmax.numpy(), np.asarray(jct.cmax))
    return dict(js=js, jc=jc, jct=jct, ts=ts, tct=tct)


@pytest.mark.parametrize("sup", [1, 4])
@pytest.mark.parametrize("kind", ["camera", "incoherent"])
def test_cull_helpers_match_jax(bunny, kind, sup):
    """``_cull_T(with_exit=True)`` on the (super)cluster boxes and
    ``_chunk_interval_cull`` on the clusters, bit for bit."""
    o, d, active = _rays(kind, bunny["jc"])
    jct, tct = bunny["jct"], bunny["tct"]
    cmin, cmax = tsweep._super_boxes(tct.cmin, tct.cmax, sup)
    jmin, jmax = jnp.asarray(cmin.numpy()), jnp.asarray(cmax.numpy())
    if sup > 1:
        # the reference's supercluster boxes (ops/cluster_sweep.py)
        pad = -(-jct.C_reg // sup) * sup - jct.C_reg
        ref_min = jnp.concatenate([jct.cmin, jnp.full((pad, 3), 3.0e38)]
                                  ).reshape(-1, sup, 3).min(axis=1)
        np.testing.assert_array_equal(cmin.numpy(), np.asarray(ref_min))
    to, td, ta = (torch.from_numpy(x) for x in (o, d, active))
    jo, jd, ja = (jnp.asarray(x) for x in (o, d, active))
    entry, exit_ = tsweep._cull_T(to, td, ta, cmin, cmax, T_MIN,
                                  with_exit=True)
    j_entry, j_exit = jsweep._cull_T(jo, jd, ja, jmin, jmax, T_MIN,
                                     with_exit=True)
    np.testing.assert_array_equal(entry.numpy(), np.asarray(j_entry))
    np.testing.assert_array_equal(exit_.numpy(), np.asarray(j_exit))
    np.testing.assert_array_equal(
        tsweep._cull_T(to, td, ta, cmin, cmax, T_MIN).numpy(),
        entry.numpy())
    assert (exit_.numpy() == -3.0e38).any() and (entry.numpy() < 1e30).any()
    ivl = tsweep._chunk_interval_cull(to, td, ta, tct.cmin, tct.cmax, T_MIN,
                                      N // 128, 128)
    j_ivl = jsweep._chunk_interval_cull(jo, jd, ja, jct.cmin, jct.cmax,
                                        T_MIN, N // 128, 128)
    np.testing.assert_array_equal(ivl.numpy(), np.asarray(j_ivl))
    # a lower bound of every active lane's entry in its chunk
    per_ray = tsweep._cull_T(to, td, ta, tct.cmin, tct.cmax, T_MIN)
    lanes = per_ray.T.reshape(N // 128, 128, -1)
    assert (ivl[:, None, :] <= lanes).all()


@pytest.mark.parametrize("cull2,sup", [(True, 4), (True, 8), (False, 4)])
@pytest.mark.parametrize("kind", ["camera", "incoherent"])
def test_plan_inputs_match_the_reference_formulas(bunny, kind, cull2, sup):
    """The march's gate and per-chunk order under a cull plan equal the
    reference's formulas (``pathtracer_tpu/ops/cluster_sweep.py``, the
    cull2 and supercluster lines of ``cluster_march``) run with JAX on
    the rays ``march_inputs`` sorted, bit for bit: the reference culls
    the sorted rays again where the port permutes its first cull's
    entries and exits; the supercluster entry repeats per member
    (``jnp.repeat``); the sorts are stable."""
    import jax
    o, d, active = _rays(kind, bunny["jc"])
    jct, tct = bunny["jct"], bunny["tct"]
    q = tsweep.march_inputs(tct, torch.from_numpy(o), torch.from_numpy(d),
                            T_MIN, active=torch.from_numpy(active),
                            cull2=cull2, sup=sup)
    gate, ids, ents = (q["args"][i].numpy() for i in (2, 3, 4))
    so, sd, sa = (jnp.asarray(q[k].numpy()) for k in ("o", "d", "active"))
    C_reg, n_chunks, big = jct.C_reg, N // 128, 3.0e38
    pad = -(-C_reg // sup) * sup - C_reg
    smin = jnp.concatenate([jct.cmin, jnp.full((pad, 3), big)]
                           ).reshape(-1, sup, 3).min(axis=1)
    smax = jnp.concatenate([jct.cmax, jnp.full((pad, 3), -big)]
                           ).reshape(-1, sup, 3).max(axis=1)
    C_cull = smin.shape[0]
    entry, exit_ = jsweep._cull_T(so, sd, sa, smin, smax, T_MIN,
                                  with_exit=True)
    far = exit_ if cull2 else entry
    ref_gate = jnp.max(jnp.where(entry >= big * 0.5, -big, far), axis=0)
    ref_gate = jnp.where(sa, ref_gate * (1.0 + 1e-5) + 1e-5, -big)
    chunk = entry.reshape(C_cull, n_chunks, 128).min(axis=2).T
    if cull2:
        ivl = jsweep._chunk_interval_cull(so, sd, sa, jct.cmin, jct.cmax,
                                          T_MIN, n_chunks, 128)
        chunk = jnp.maximum(ivl, jnp.repeat(chunk, sup, axis=1)[:, :C_reg])
    iota = jnp.broadcast_to(jnp.arange(chunk.shape[1], dtype=jnp.int32),
                            chunk.shape)
    ref_ents, ref_ids = jax.lax.sort_key_val(chunk, iota, dimension=1)
    if not cull2:
        ref_ids = jnp.minimum(ref_ids[:, :, None] * sup + jnp.arange(sup),
                              C_reg - 1).reshape(n_chunks, -1)
        ref_ents = jnp.repeat(ref_ents, sup, axis=1)
    np.testing.assert_array_equal(gate, np.asarray(ref_gate))
    np.testing.assert_array_equal(ids[:, :-1], np.asarray(ref_ids))
    np.testing.assert_array_equal(ents[:, :-1], np.asarray(ref_ents))
    assert (ids[:, -1] == 0).all() and (ents[:, -1] == big).all()
    assert (q["cull2"], q["sup"]) == (cull2, sup)


def test_cull_plan_rule():
    """The reference's plan: cull2 from 2,048 regular clusters (or the
    given count), sup ceil(C_reg / 512) under cull2, 1 without; forced
    values win."""
    plan = tsweep.cull_plan
    assert plan(57) == (False, 1)
    assert plan(905) == (False, 1)
    assert plan(2047) == (False, 1) and plan(2048) == (True, 4)
    assert plan(3617) == (True, 8) and plan(14465) == (True, 29)
    assert plan(57, cull2_clusters=32) == (True, 1)
    assert plan(3617, cull2=False) == (False, 1)
    assert plan(57, cull2=True, sup=8) == (True, 8)
    assert plan(905, sup=4) == (False, 4)
    with pytest.raises(ValueError, match="positive"):
        plan(57, sup=0)


def test_auto_switch_matches_jax(bunny, monkeypatch):
    """With ``PT_CLUSTER_CULL2_C=32`` the bunny (57 regular clusters)
    takes cull2 in both packages, with the same supercluster size: the
    reference's per-ray cull returns exits (only cull2 asks for them) on
    C_reg / sup boxes, and it runs the bundle cull."""
    for var in ("PT_CLUSTER_CULL2", "PT_CLUSTER_SUPER"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PT_CLUSTER_CULL2_C", "32")
    _, kw = trenderer.cluster_options()
    assert kw == dict(cull2_clusters=32)
    closest = tsweep.make_cluster_closest_hit(bunny["tct"], T_MIN, **kw)
    assert closest.cull_plan == (True, 1)
    seen = []
    cull_t, interval = jsweep._cull_T, jsweep._chunk_interval_cull

    def spy_cull(o, d, active, cmin, cmax, t_min, with_exit=False):
        seen.append(("cull", cmin.shape[0], with_exit))
        return cull_t(o, d, active, cmin, cmax, t_min, with_exit=with_exit)

    def spy_interval(*args):
        seen.append(("interval",))
        return interval(*args)
    monkeypatch.setattr(jsweep, "_cull_T", spy_cull)
    monkeypatch.setattr(jsweep, "_chunk_interval_cull", spy_interval)
    o, d, _ = _rays("camera", bunny["jc"])
    ref = [np.asarray(x) for x in jsweep.cluster_march(
        bunny["jct"], jnp.asarray(o), jnp.asarray(d), T_MIN)]
    assert ("cull", 57, True) in seen and ("interval",) in seen
    got = [x.numpy() for x in closest(torch.from_numpy(o),
                                      torch.from_numpy(d))]
    np.testing.assert_array_equal(got[2], ref[2])
    both = got[2] & ref[2]
    np.testing.assert_allclose(got[1][both], ref[1][both], rtol=1e-5,
                               atol=2e-4)
    monkeypatch.setenv("PT_CLUSTER_CULL2_C", "58")
    _, kw = trenderer.cluster_options()
    assert tsweep.make_cluster_closest_hit(bunny["tct"], T_MIN,
                                           **kw).cull_plan == (False, 1)


def test_level1_render_cull2_matches_flat(monkeypatch):
    """The level-1 bunny (227 regular clusters) at 32x16, 1 spp, depth 2,
    chunk 512 (four 128-ray march chunks), with cull2 forced on and off."""
    ts, tc = tbunny.bunny_world(subdivide=1, device="cpu")
    cfg = TConfig(width=32, height=16, spp=1, max_depth=2, ray_chunk=512,
                  accel="cluster", scene="bunny")
    imgs = {}
    for cull2 in ("1", "0"):
        monkeypatch.setenv("PT_CLUSTER_CULL2", cull2)
        render = trenderer.make_renderer(cfg, "cpu")
        assert render.prepare(ts).closest.cull_plan == (cull2 == "1", 1)
        imgs[cull2] = render(ts, tc).numpy()
    assert np.isfinite(imgs["1"]).all() and imgs["1"].mean() > 0.1
    np.testing.assert_allclose(imgs["1"], imgs["0"], rtol=0, atol=1e-6)


def test_scaling_tool_on_the_cpu():
    """The scaling tool's CPU run: a 300-sphere cloud, 256 rays, both
    culls with and without superclusters of 4; every march agrees with the
    dense sweep on every valid flag."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_prim_scaling.main(
            ["--device", "cpu", "--sizes", "300", "--rays", "256",
             "--iters", "1", "--cull", "flat,cull2", "--sup", "auto,4"])
    text = out.getvalue()
    assert rc == 0, text
    assert "N=300" in text and "dense (K2)" in text and "tensor" in text
    assert "(flat, sup 4)" in text and "(cull2, sup 4)" in text, text
    assert text.count("valid-agree 1.0000") == 4, text


def test_dense_routes_tool_on_the_cpu():
    """The dense-routes tool's CPU run on cornell-full: the camera, bounce
    and shadow queries of a 16x16 one-chunk render, each through both
    routes, host times only."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_dense_routes.main(
            ["--device", "cpu", "--scenes", "cornell", "--rays", "256",
             "--iters", "1"])
    text = out.getvalue()
    assert rc == 0, text
    lines = [ln for ln in text.splitlines() if ln.startswith("cornell")]
    assert [ln.split(") ")[1].split(" (")[0] for ln in lines] == [
        "camera", "bounce", "shadow"], text
    assert all("K2 host" in ln and "tensor host" in ln and "device" not in ln
               for ln in lines), text
    assert "(t_min 1e-07)" in lines[2], text
