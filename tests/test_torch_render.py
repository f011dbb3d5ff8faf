"""The port's whole render against the JAX reference at the same seed, the
CLI, and the port's independence from JAX.

Tolerance: >= 99% of pixel channels within 1e-4 and mean |diff| <= 1e-3.
The random streams are bit-equal, but the two sweeps differ at ulp level
(bf16x6 split vs plain float32), so a near-tie winner can flip and change
one path; transcendental functions also differ by an ulp between the two
libraries.

The Cornell and triangle-world renders hold the port against the reference
run op by op (``jax.disable_jit``). Jitted, XLA's CPU fusion rounds a few
of the reference's own ops differently: on those scenes the jitted
reference differs from its op-by-op run on more than 1% of channels (a
bounce origin a few ulps to either side of a surface flips a
self-intersection), which is the reference disagreeing with itself, not
the port with the reference.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu import presets as jpresets
from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.render.renderer import render_image as jrender
from pathtracer_tpu.scene import cornell as jcornell
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch import presets as tpresets
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.render.renderer import render_image as trender
from pathtracer_tpu_torch.scene import bunny as tbunny
from pathtracer_tpu_torch.scene import worlds as tworlds

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(world):
    js, jc = jworlds.get_world(world)
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    # the port's camera equals the reference's (tests/test_torch_scene.py)
    _, tc = tworlds.get_world(world, device="cpu")
    return js, jc, ts, tc


def _reference_op_by_op(js, jc, jcfg):
    """The reference render with every op run on its own (no XLA
    fusion)."""
    with jax.disable_jit():
        return np.asarray(jrender(js, jc, jcfg))


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
    img = trender(ts, tc, TConfig(**kw), device="cpu").numpy()
    _assert_images_close(img, ref)


def test_port_world_render_matches_jax():
    """The port's own bunny build and camera (not the converter), auto
    accel, as the CLI runs it."""
    js, jc = jworlds.get_world("bunny")
    ts, tc = tworlds.get_world("bunny", device="cpu")
    kw = dict(width=24, height=16, spp=1, max_depth=4, ray_chunk=384,
              scene="bunny")
    ref = np.asarray(jrender(js, jc, JConfig(**kw)))
    img = trender(ts, tc, TConfig(**kw), device="cpu").numpy()
    _assert_images_close(img, ref)


@pytest.mark.parametrize("preset,accel", [
    ("cornell-direct", "pallas"), ("cornell-direct", "tensor"),
    ("cornell-full", "pallas"), ("cornell-full", "tensor")])
def test_cornell_preset_matches_jax(preset, accel, tmp_path, monkeypatch):
    """The Cornell presets with NEE, stratified jitter (4 spp: a 2x2
    sub-pixel grid) and, in cornell-full, both textures, through the dense
    sweep (the port's twin against Pallas interpret mode) and the tensor
    route; both packages take the built-in Cornell data."""
    monkeypatch.delenv("PT_CORNELL_DIR", raising=False)
    variant = preset.split("-")[1]
    variant = "spheres" if variant == "direct" else variant
    js, jc = jcornell.cornell_box(obj_dir=str(tmp_path), variant=variant)
    ts, tc, tcfg = tpresets.get_preset(preset, device="cpu")
    small = dict(width=32, height=32, spp=4, max_depth=min(tcfg.max_depth,
                                                           3),
                 ray_chunk=1024, accel=accel, seed=3)
    tcfg = tcfg.replace(**small)
    assert tcfg.nee and tcfg.stratify and not tcfg.sky
    ref = _reference_op_by_op(js, jc, JConfig.from_json(tcfg.to_json()))
    img = trender(ts, tc, tcfg, device="cpu").numpy()
    assert img.mean() > 0.05          # lit by the area light alone
    _assert_images_close(img, ref)


@pytest.mark.parametrize("accel", ["auto", "pallas"])
def test_triangle_world_matches_jax(accel):
    """The reference's own default scene (601 prims, auto = tensor) and the
    dense sweep kernel's route, at depth 4."""
    js, jc = jworlds.get_world("triangle")
    ts, tc = tworlds.get_world("triangle", device="cpu")
    kw = dict(width=32, height=18, spp=1, max_depth=4, ray_chunk=576,
              accel=accel, scene="triangle", seed=1)
    ref = _reference_op_by_op(js, jc, JConfig(**kw))
    img = trender(ts, tc, TConfig(**kw), device="cpu").numpy()
    _assert_images_close(img, ref)


def test_combined_nee_on_march_matches_jax(tmp_path, monkeypatch):
    """NEE through the cluster march: the bunny in the Cornell room (lit
    by its area light; the bunny world itself has no emitter, so NEE there
    casts no shadow ray). The shadow rays take the march's query_shadow."""
    monkeypatch.setenv("PT_BUNNY_OBJ", tbunny.ASSET_OBJ)
    monkeypatch.delenv("PT_CORNELL_DIR", raising=False)
    monkeypatch.setattr(jcornell, "CORNELL_DIR", str(tmp_path))
    js, jc = jpresets.combined_scene()
    ts, tc = tpresets.combined_scene(device="cpu")
    kw = dict(width=32, height=18, spp=1, max_depth=3, ray_chunk=576,
              accel="cluster", sky=False, nee=True, scene="combined",
              seed=2)
    ref = np.asarray(jrender(js, jc, JConfig(**kw)))
    img = trender(ts, tc, TConfig(**kw), device="cpu").numpy()
    assert img.mean() > 0.05
    _assert_images_close(img, ref)


def test_render_stats_and_determinism():
    from pathtracer_tpu_torch.render.renderer import make_renderer
    ts, tc = tworlds.get_world("bunny", device="cpu")
    cfg = TConfig(width=16, height=16, spp=1, max_depth=2, ray_chunk=256,
                  scene="bunny")
    render = make_renderer(cfg, "cpu", with_stats=True)
    img, (n_queries, n_shadow, n_pairs) = render(ts, tc, seed=3)
    assert render.prepare(ts) is render.prepare(ts)   # built once
    assert 256 <= n_queries <= 2 * 256 and n_pairs > 0
    assert n_shadow == 0                              # no NEE
    again, _ = render(ts, tc, seed=3)
    np.testing.assert_array_equal(img.numpy(), again.numpy())
    other, _ = render(ts, tc, seed=4)
    assert not np.array_equal(img.numpy(), other.numpy())


def test_cli_and_no_jax_import(tmp_path):
    """Port renders in a fresh interpreter import neither jax nor the JAX
    package (the test process itself has both loaded): the bunny, a
    cornell-full preset (NEE, stratify, textures, the dense sweep), the
    bunny on the rounds route with the Sobol sampler, Russian roulette and
    black termination, the big-scene example, and a checkpointed render in
    passes."""
    out = tmp_path / "t.png"
    out2 = tmp_path / "c.png"
    out3 = tmp_path / "r.png"
    out4 = tmp_path / "big.png"
    out5 = tmp_path / "k.png"
    ck = tmp_path / "k.npz"
    code = (
        "import os, sys\n"
        "from pathtracer_tpu_torch.__main__ import main\n"
        f"rc = main(['--scene', 'bunny', '--width', '16', '--height', '8',"
        f" '--spp', '1', '--max-depth', '2', '--ray-chunk', '128',"
        f" '--device', 'cpu', '-o', {str(out)!r}])\n"
        f"rc = rc or main(['--preset', 'cornell-full', '--scale', '0.0625',"
        f" '--accel', 'pallas', '--ray-chunk', '256', '--device', 'cpu',"
        f" '-o', {str(out2)!r}])\n"
        "os.environ.update(PT_CLUSTER_STRATEGY='rounds', PT_CLUSTER_K='128')\n"
        f"rc = rc or main(['--scene', 'bunny', '--width', '16', '--height',"
        f" '8', '--spp', '2', '--max-depth', '3', '--ray-chunk', '128',"
        f" '--sampler', 'sobol', '--rr', '--rr-depth', '1',"
        f" '--terminate-black', '--device', 'cpu', '-o', {str(out3)!r}])\n"
        "os.environ.pop('PT_CLUSTER_STRATEGY'); os.environ.pop('PT_CLUSTER_K')\n"
        "from pathtracer_tpu_torch.examples.big_scene import main as big\n"
        f"rc = rc or big(['--device', 'cpu', '--level', '0', '--width', '32',"
        f" '--spp', '1', '--out', {str(out4)!r}])\n"
        f"rc = rc or main(['--scene', 'test', '--width', '16', '--height', '8',"
        f" '--spp', '2', '--max-depth', '2', '--ray-chunk', '128',"
        f" '--spp-per-pass', '1', '--checkpoint', {str(ck)!r},"
        f" '--device', 'cpu', '-o', {str(out5)!r}])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathtracer_tpu' or m.startswith('pathtracer_tpu.')]\n"
        "print('LOADED', bad)\n"
        "sys.exit(rc or (1 if bad else 0))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert "16x16, 4 spp" in proc.stdout and "nee" in proc.stdout
    assert "level 0: 3619 primitives, 57 regular clusters" in proc.stdout
    assert "  2/2 spp" in proc.stdout and ck.exists()
    for path in (out, out2, out3, out4, out5):
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
