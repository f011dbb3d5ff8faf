"""The port's NumPy oracle (``pathtracer_tpu_torch/oracle.py``) against the
JAX package's oracle, and the port's renderer against the oracle.

On bit-equal scenes and cameras both oracles draw from
``numpy.random.default_rng(seed)`` and run the same float32 NumPy code, so
their images are held to the bit. The renderer-vs-oracle parity runs use
``tests/test_oracle.py::_assert_parity``'s noise-scaled bounds (the
renderer's random streams are not the oracle's).
"""
import numpy as np
import pytest
import torch

from pathtracer_tpu import oracle as joracle
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch import oracle
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.core.camera import Camera
from pathtracer_tpu_torch.ops import intersect
from test_oracle import _assert_parity

torch.set_num_threads(1)

W, H = 64, 36


def _both(name):
    js, jc = jworlds.get_world(name)
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    return js, jc, ts, Camera(*(torch.from_numpy(np.array(x)) for x in jc))


@pytest.mark.parametrize("name,depth", [("test", 8), ("triangle", 3)])
def test_oracle_bit_equal_to_jax_oracle(name, depth):
    js, jc, ts, tc = _both(name)
    want = joracle.render(js, jc, 16, 9, 4, depth, seed=5)
    got = oracle.render(ts, tc, 16, 9, 4, depth, seed=5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].mean() > 0.05


def test_oracle_closest_hit_matches_brute():
    """The oracle's factored closest hit against the port's brute force
    (two numerical paths: the same verdicts away from razor-edge ties),
    and bit-equal to the JAX oracle's."""
    js, jc, ts, tc = _both("test")
    sn = oracle.scene_to_np(ts)
    rng = np.random.default_rng(3)
    n = 512
    u = rng.random(n, dtype=np.float32)
    v = rng.random(n, dtype=np.float32)
    o, d = oracle.get_rays(tc, u, v, rng)
    idx_o, t_o, valid_o = oracle.closest_hit(sn, o, d, 1e-3,
                                             float(oracle.INF))
    j = joracle.closest_hit(joracle.scene_to_np(js), o, d, 1e-3,
                            float(joracle.INF))
    for a, b in zip((idx_o, t_o, valid_o), j):
        np.testing.assert_array_equal(a, b)
    idx_b, t_b, valid_b = (x.numpy() for x in intersect.brute_force_closest(
        ts, torch.from_numpy(o), torch.from_numpy(d), 1e-3,
        intersect.BIG_T))
    assert np.array_equal(valid_o, valid_b) and valid_o.mean() > 0.3
    agree = idx_o[valid_o] == idx_b[valid_o]
    assert agree.mean() > 0.995, agree.mean()
    same = valid_o & (idx_o == idx_b)
    np.testing.assert_allclose(t_o[same], t_b[same], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("depth", [8, 1])
def test_oracle_parity_test_world(depth):
    """The port's renderer against the oracle (``compare_to_torch``);
    depth 1 isolates the reference's exhaustion quirk: a ray that hits
    scatters once, runs out of depth and returns sky(scattered direction)
    * attenuation."""
    _, _, ts, tc = _both("test")
    mean, _ = oracle.render(ts, tc, W, H, 24, depth, seed=7)
    stats = oracle.compare_to_torch(ts, tc, W, H, 24, depth, mean, seed=7,
                                    scene_name="test", device="cpu")
    assert stats["torch_spp"] == 24
    _assert_parity(stats, f"test, depth {depth}")


def test_oracle_cli(capsys):
    oracle.main(["--scene", "test", "--width", "16", "--height", "9",
                 "--spp", "2", "--depth", "3", "--compare", "--device",
                 "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json
    out = json.loads(line)
    assert out["scene"] == "test" and out["torch_spp"] == 2
    assert out["mean_radiance"] > 0.05
