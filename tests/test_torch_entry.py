"""The port's compile-check entry (``pathtracer_tpu_torch/entry.py``) and
inverse-rendering example (``examples/inverse_rendering.py``) on the CPU.

- ``entry()``'s forward step equals ``render_image`` bit for bit (the same
  render_sum and finish, one pass), at a reduced size;
  ``dryrun_multichip`` gives a finite loss on CPU slots.
- The example's loss history equals the JAX ``diff.fit`` on the same
  inputs (the JAX example's scene, perturbation and configuration) within
  rtol 1e-4, as ``tests/test_torch_diff.py`` holds fits. The reference
  runs op by op (``jax.disable_jit``): on the Cornell scenes its compiled
  render differs from its own op-by-op run on ~1% of channels (ROADMAP
  Queue 3), the port equals the op-by-op run.
- None of the ported entry points (the bench and its child, the scaling
  bench and its proxy, the example, the entry) imports ``jax`` or the JAX
  package, checked in a fresh interpreter.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.render import diff as jdiff
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene.cornell import cornell_box as jcornell_box
from pathtracer_tpu_torch.entry import ENTRY_CFG, dryrun_multichip, entry
from pathtracer_tpu_torch.examples import inverse_rendering
from pathtracer_tpu_torch.render.renderer import render_image

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_step_equals_render_image():
    cfg = ENTRY_CFG.replace(width=32, height=18, ray_chunk=576)
    fn, (scene, cam, seed) = entry("cpu", cfg)
    assert seed == 0 and scene.num_prims == 3619
    img = fn(scene, cam, seed)
    assert tuple(img.shape) == (18, 32, 3)
    assert torch.equal(img, render_image(scene, cam, cfg, seed=0,
                                         device="cpu"))
    assert not torch.equal(img, fn(scene, cam, 1))


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_on_cpu_slots(n):
    loss = dryrun_multichip(n, device="cpu")
    assert np.isfinite(loss) and loss > 0.0


def test_example_loss_history_matches_jax(tmp_path):
    size, spp, steps = 16, 2, 3
    result = inverse_rendering.run(steps=steps, size=size, spp=spp,
                                   device="cpu", out_dir=str(tmp_path))
    for name in ("target.png", "initial.png", "fitted.png"):
        assert (tmp_path / name).stat().st_size > 0
    assert json.loads((tmp_path / "history.json").read_text()) == result

    # the JAX example's inputs, op by op
    jscene, jcam = jcornell_box(variant="spheres")
    cfg = JConfig(width=size, height=size, spp=spp, max_depth=2, sky=False,
                  nee=True, accel="brute", ray_chunk=size * size,
                  scene="cornell")
    rows, cols = jrenderer.padded_pixel_grid(cfg, size * size)
    true_albedo = np.asarray(jscene.albedo)
    init_albedo = true_albedo * np.float32(0.3) + np.float32(0.45)
    start = jscene._replace(albedo=jnp.asarray(init_albedo, jnp.float32))
    with jax.disable_jit():
        target = jdiff.render_linear(jscene, None, jcam,
                                     jax.random.PRNGKey(0), rows, cols, cfg,
                                     spp)[:size * size]
        _, history = jdiff.fit(start, None, jcam, target, cfg, steps=steps,
                               lr=0.05, param_fields=("albedo",), seed=0,
                               resample=False)
    np.testing.assert_allclose(result["loss"], history, rtol=1e-4)
    summary = result["summary"]
    assert summary["albedo_mae_initial"] == pytest.approx(
        float(np.abs(init_albedo - true_albedo).mean()), rel=1e-6)
    assert summary["loss_last"] < summary["loss_first"]
    assert summary["albedo_mae_fitted"] < summary["albedo_mae_initial"]


def test_entry_points_import_no_jax(tmp_path):
    """The bench (its child's body), the scaling bench and its proxy, the
    example and the entry, each run at a tiny size on the CPU in a fresh
    interpreter, load neither jax nor the JAX package."""
    tiny = ("'--scene', 'test', '--accel', 'brute', '--width', '16', "
            "'--height', '8', '--spp', '1', '--depth', '2', '--iters', '1'")
    code = (
        "import sys\n"
        "from pathtracer_tpu_torch import bench, bench_scaling, entry\n"
        "from pathtracer_tpu_torch.examples import inverse_rendering\n"
        f"rc = bench.main(['--child', '--device', 'cpu', {tiny}])\n"
        f"rc = rc or bench_scaling.main(['--device', 'cpu', {tiny}])\n"
        f"rc = rc or bench_scaling.main(['--proxy', '--proxy-devices', "
        f"'cpux4', {tiny}, '--out', {str(tmp_path / 'p.json')!r}])\n"
        "rc = rc or inverse_rendering.main(['--device', 'cpu', '--size', "
        f"'8', '--spp', '1', '--steps', '1', '--out-dir', "
        f"{str(tmp_path / 'inv')!r}])\n"
        "fn, args = entry.entry('cpu', entry.ENTRY_CFG.replace(width=16, "
        "height=9, ray_chunk=144))\n"
        "fn(*args)\n"
        "entry.dryrun_multichip(2, 'cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathtracer_tpu' or m.startswith('pathtracer_tpu.')]\n"
        "print('LOADED', bad)\n"
        "sys.exit(rc or (1 if bad else 0))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "LOADED []" in proc.stdout
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    # the bench's line, the scaling line, the proxy's line, the summary
    assert [ln.get("metric") for ln in lines[:2]] == [
        "test_forward_throughput", "scaling"]
    assert lines[2]["sums_match"] and "loss_last" in lines[3]
