"""The port's CUDA kernels on the card, against their plain PyTorch twins.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. The file
imports neither jax nor the JAX package, so it runs where only PyTorch is
installed; the repository's conftest imports jax, hence on a GPU machine:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: those of tests/test_torch_march.py (kernel and twin are built
to round alike, so they are expected to agree to the bit).
"""
import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.core.camera import get_rays
from pathtracer_tpu_torch.ops import cluster_sweep
from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
from pathtracer_tpu_torch.render.renderer import make_renderer
from pathtracer_tpu_torch.scene.scene import PRIM_SPHERE
from pathtracer_tpu_torch.scene.worlds import get_world

pytestmark = pytest.mark.cuda

T_MIN = 1e-3


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _wavefront(name, cam, n, dev):
    if name == "camera":
        u = prng.uniform(prng.PRNGKey(1), (4, n), dev)
        o, d, _ = get_rays(cam, u[0], u[1], u[2], u[3],
                           torch.zeros(n, device=dev))
        return o, d
    rng = np.random.default_rng(2)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) * 0.5
    d = rng.standard_normal((n, 3)).astype(np.float32)
    if name == "dead":
        d[::5] = 0.0
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


@pytest.mark.parametrize("name", ["camera", "bounce", "dead"])
@pytest.mark.parametrize("n", [512, 57600])
def test_march_kernel_matches_twin(gpu, name, n):
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront(name, cam, n, gpu)
    q = cluster_sweep.march_inputs(ct, o, d, T_MIN)
    before = cluster_sweep.MARCH_LAUNCHES
    t_k, b_k, s_k = (x.cpu().numpy() for x in cluster_sweep.march(
        *q["args"]))
    assert cluster_sweep.MARCH_LAUNCHES == before + 1
    t_r, b_r, s_r = (x.cpu().numpy() for x in cluster_sweep.march_reference(
        *q["args"]))
    assert cluster_sweep.MARCH_LAUNCHES == before + 1
    v_k, v_r = b_k >= 0, b_r >= 0
    assert (v_k == v_r).mean() >= 0.999
    both = v_k & v_r
    assert (b_k == b_r)[both].mean() >= 0.999
    dt = np.abs(t_k - t_r)
    differ = both & (b_k != b_r)
    assert (dt[differ] <= 1e-5 * np.abs(t_r[differ])).all()
    prim_type = ct.scene.prim_type.cpu().numpy()
    sph = both & (prim_type[np.maximum(b_r, 0)] == PRIM_SPHERE)
    tri = both & ~sph
    np.testing.assert_allclose(t_k[tri], t_r[tri], rtol=1e-5, atol=0)
    np.testing.assert_allclose(t_k[sph], t_r[sph], rtol=1e-5, atol=2e-4)
    assert abs(int(s_k.sum()) - int(s_r.sum())) <= 0.001 * s_r.sum()


def test_march_wrapper_rejects_bad_inputs(gpu):
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront("camera", cam, 256, gpu)
    args = list(cluster_sweep.march_inputs(ct, o, d, T_MIN)["args"])
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError):
        cluster_sweep.march(*bad)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError):
        cluster_sweep.march(*bad)


def test_small_render_matches_cpu(gpu):
    cfg = RenderConfig(width=64, height=36, spp=2, max_depth=3,
                       ray_chunk=64 * 36, accel="cluster", scene="bunny",
                       seed=5)
    scene, cam = get_world("bunny", device=gpu)
    cluster_sweep.MARCH_LAUNCHES = 0
    g = make_renderer(cfg, gpu)(scene, cam).cpu().numpy()
    assert cluster_sweep.MARCH_LAUNCHES > 0
    scene_c, cam_c = get_world("bunny", device="cpu")
    c = make_renderer(cfg, "cpu")(scene_c, cam_c).numpy()
    diff = np.abs(g - c)
    assert np.isfinite(g).all()
    assert (diff <= 1e-4).mean() >= 0.99 and diff.mean() <= 1e-3
