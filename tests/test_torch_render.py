"""The port's whole render against the JAX reference at the same seed, the
CLI, and the port's independence from JAX.

Tolerance: >= 99% of pixel channels within 1e-4 and mean |diff| <= 1e-3.
The random streams are bit-equal, but the two sweeps differ at ulp level
(bf16x6 split vs plain float32), so a near-tie winner can flip and change
one path; transcendental functions also differ by an ulp between the two
libraries.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.render.renderer import render_image as jrender
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.render.renderer import render_image as trender
from pathtracer_tpu_torch.scene import worlds as tworlds

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(world):
    js, jc = jworlds.get_world(world)
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields})
    # the port's camera equals the reference's (tests/test_torch_scene.py)
    _, tc = tworlds.get_world(world)
    return js, jc, ts, tc


def _assert_images_close(a, b):
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    diff = np.abs(a - b)
    assert (diff <= 1e-4).mean() >= 0.99, (diff <= 1e-4).mean()
    assert diff.mean() <= 1e-3, diff.mean()


@pytest.mark.parametrize("world,w,h,chunk,seed", [
    # sorted-wavefront path (R a multiple of the 128-ray chunk)
    ("bunny", 32, 16, 512, 0),
    ("bunny", 32, 16, 256, 7),
    # unsorted query path: 450 rays are not a multiple of 128; the test
    # world has 3 prims, so accel="cluster" is forced
    ("test", 30, 15, 450, 0),
])
def test_render_matches_jax(world, w, h, chunk, seed):
    js, jc, ts, tc = _both(world)
    kw = dict(width=w, height=h, spp=2, max_depth=3, ray_chunk=chunk,
              accel="cluster", scene=world, seed=seed)
    ref = np.asarray(jrender(js, jc, JConfig(**kw)))
    img = trender(ts, tc, TConfig(**kw)).numpy()
    _assert_images_close(img, ref)


def test_port_world_render_matches_jax():
    """The port's own bunny build and camera (not the converter), auto
    accel, as the CLI runs it."""
    js, jc = jworlds.get_world("bunny")
    ts, tc = tworlds.get_world("bunny")
    kw = dict(width=24, height=16, spp=1, max_depth=4, ray_chunk=384,
              scene="bunny")
    ref = np.asarray(jrender(js, jc, JConfig(**kw)))
    img = trender(ts, tc, TConfig(**kw)).numpy()
    _assert_images_close(img, ref)


def test_render_stats_and_determinism():
    from pathtracer_tpu_torch.render.renderer import make_renderer
    ts, tc = tworlds.get_world("bunny")
    cfg = TConfig(width=16, height=16, spp=1, max_depth=2, ray_chunk=256,
                  scene="bunny")
    render = make_renderer(cfg, "cpu", with_stats=True)
    img, (n_queries, n_pairs) = render(ts, tc, seed=3)
    assert render.tables(ts) is render.tables(ts)   # built once
    assert 256 <= n_queries <= 2 * 256 and n_pairs > 0
    again, _ = render(ts, tc, seed=3)
    np.testing.assert_array_equal(img.numpy(), again.numpy())
    other, _ = render(ts, tc, seed=4)
    assert not np.array_equal(img.numpy(), other.numpy())


def test_cli_and_no_jax_import(tmp_path):
    """A port render in a fresh interpreter imports neither jax nor the
    JAX package (the test process itself has both loaded)."""
    out = tmp_path / "t.png"
    code = (
        "import sys\n"
        "from pathtracer_tpu_torch.__main__ import main\n"
        f"rc = main(['--scene', 'bunny', '--width', '16', '--height', '8',"
        f" '--spp', '1', '--max-depth', '2', '--ray-chunk', '128',"
        f" '--device', 'cpu', '-o', {str(out)!r}])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathtracer_tpu' or m.startswith('pathtracer_tpu.')]\n"
        "print('LOADED', bad)\n"
        "sys.exit(rc or (1 if bad else 0))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
