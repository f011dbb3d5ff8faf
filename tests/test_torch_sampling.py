"""The port's sampling options against the JAX reference: the
Owen-scrambled Sobol pixel filter bit for bit, Russian roulette, the Sobol
sampler and black termination in whole renders, and the CLI flags that set
them.

Tolerances: ``sobol_owen_2d`` is integer arithmetic and must be bit-equal.
Renders use the render tolerance of tests/test_torch_render.py (>= 99% of
pixel channels within 1e-4, mean |diff| <= 1e-3): the random streams are
bit-equal, but the two sweeps differ at ulp level, so a near-tie winner
can flip and change one path. The Sobol renders hold the port against the
jitted reference: the reference cannot run its Sobol render op by op (its
renderer calls ``.astype`` on the Python sample index that
``jax.disable_jit`` passes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu.__main__ as jcli
from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.core import sampling as jsampling
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch import __main__ as tcli
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.core import sampling as tsampling
from pathtracer_tpu_torch.render.renderer import render_image as trender
from pathtracer_tpu_torch.scene import worlds as tworlds

torch.set_num_threads(1)


@pytest.fixture
def sobol_cache(monkeypatch):
    """The reference caches its Sobol direction numbers in a module global
    on first use; filled inside a jitted render, the cache holds a tracer
    that a second jitted render in the same process cannot use. Fill it
    eagerly for the test."""
    monkeypatch.setattr(jsampling, "_SOBOL_DIR_1", None)
    jsampling._sobol_dir_1()


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 3])
def test_sobol_owen_2d_bit_equal(seed):
    """Sample indices 0..255 for pixels spread over a 1080p frame and the
    edge of the 32-bit range."""
    rng = np.random.default_rng(seed % 2 ** 32)
    pix = np.concatenate([rng.integers(0, 1920 * 1080, 14),
                          [0, 2 ** 31 - 1]]).astype(np.int32)
    samples = np.repeat(np.arange(256, dtype=np.uint32), pix.size)
    pixels = np.tile(pix, 256)
    j = jsampling.sobol_owen_2d(jnp.asarray(samples), jnp.asarray(pixels),
                                seed)
    t = tsampling.sobol_owen_2d(torch.from_numpy(samples.astype(np.int64)),
                                torch.from_numpy(pixels), seed)
    for a, b in zip(j, t):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # a Python-int sample index, as the renderer passes it
    j1 = jsampling.sobol_owen_2d(jnp.uint32(200), jnp.asarray(pix), seed)
    t1 = tsampling.sobol_owen_2d(200, torch.from_numpy(pix), seed)
    for a, b in zip(j1, t1):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert 0.0 <= float(t[0].min()) and float(t[0].max()) < 1.0


def test_mul32_wraps_like_uint32():
    """The 16-bit-half product equals the uint32 product mod 2^32, with no
    int64 overflow, on random words and the edges of the range."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint64),
                        [0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31,
                         2 ** 32 - 1]]).astype(np.uint32)
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6, 0x7FEB352D,
              0x846CA68B, 0xFFFFFFFF, 1):
        want = x * np.uint32(c)          # numpy wraps uint32 products
        got = tsampling._mul32(torch.from_numpy(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("opts", [
    dict(rr=True, rr_depth=1), dict(sampler="sobol"),
    dict(terminate_black=True)])
def test_option_render_matches_jax(opts, sobol_cache):
    """The bunny through the march with Russian roulette from bounce 1,
    the Sobol pixel filter, or black termination."""
    js, jc = jworlds.get_world("bunny")
    ts, tc = tworlds.get_world("bunny", device="cpu")
    kw = dict(width=32, height=16, spp=2, max_depth=3, ray_chunk=512,
              accel="cluster", scene="bunny", seed=0, **opts)
    ref = np.asarray(jrenderer.render_image(js, jc, JConfig(**kw)))
    img = trender(ts, tc, TConfig(**kw), device="cpu").numpy()
    plain = trender(ts, tc, TConfig(**{**kw, **dict(
        rr=False, sampler="random", terminate_black=False)}),
        device="cpu").numpy()
    assert np.isfinite(img).all() and img.mean() > 0.3
    assert not np.array_equal(img, plain)     # the option changes the image
    diff = np.abs(img - ref)
    assert (diff <= 1e-4).mean() >= 0.99, (diff <= 1e-4).mean()
    assert diff.mean() <= 1e-3, diff.mean()


SIZE = ["--width", "16", "--height", "8", "--spp", "2", "--max-depth", "3",
        "--ray-chunk", "128"]


@pytest.mark.parametrize("argv", [
    ["--scene", "test"] + SIZE,
    ["--scene", "test", "--rr"] + SIZE,
    ["--scene", "test", "--sampler", "sobol", "--rr", "--rr-depth", "1",
     "--terminate-black", "--seed", "9"] + SIZE,
    ["--preset", "bunny", "--scale", "0.0625", "--sampler", "sobol", "--rr",
     "--rr-depth", "2"],
    ["--preset", "cornell-diff", "--scale", "0.125"],
    [],
])
def test_cli_flags_match_reference(argv, monkeypatch, tmp_path):
    """The port's CLI builds the same RenderConfig as the reference's CLI
    from the same arguments (the reference's render and PNG write are
    stubbed; its scenes are not built). The port also applies
    --terminate-black to a preset, where the reference drops it; that case
    is not compared."""
    seen = {}

    def fake_render(scene, cam, cfg, *a, **k):
        seen["cfg"] = cfg
        return np.zeros((cfg.height, cfg.width, 3), np.float32)
    monkeypatch.setattr(jrenderer, "render_image", fake_render)
    monkeypatch.setattr(jworlds, "get_world", lambda name: (None, None))
    monkeypatch.setattr("pathtracer_tpu.io.png.write_png",
                        lambda path, img: None)
    assert jcli.main(argv + ["--spp-per-pass", "100000", "-o",
                             str(tmp_path / "j.png")]) == 0
    args = tcli.build_parser().parse_args(argv + ["--device", "cpu"])
    _, _, cfg = tcli.scene_and_config(args, "cpu")
    assert cfg.to_json() == seen["cfg"].to_json()


def test_cli_defaults_match_reference():
    """With no flags both CLIs parse the same values for every flag they
    share: the triangle world, 800x450, 100 spp, depth 50, 16,384-ray
    chunks (applied when the config is built)."""
    port = vars(tcli.build_parser().parse_args([]))
    ref = vars(jcli.build_parser().parse_args([]))
    shared = set(port) & set(ref)
    assert {"scene", "width", "height", "spp", "max_depth", "ray_chunk",
            "accel", "preset", "scale", "output"} <= shared
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    _, _, cfg = tcli.scene_and_config(
        tcli.build_parser().parse_args(["--scene", "test"]), "cpu")
    assert (cfg.width, cfg.height, cfg.spp, cfg.max_depth, cfg.ray_chunk) \
        == (800, 450, 100, 50, 16384)
