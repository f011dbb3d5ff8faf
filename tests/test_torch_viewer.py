"""The port's interactive viewer (``viewer/interactive.py``) against the
JAX package's: the session's accumulation and restarts, the ANSI frame,
and frames equal to the reference session's at the same seed (images as
``tests/test_torch_render.py``: >= 99% of channels within 1e-4, mean
|diff| <= 1e-3)."""
import io

import numpy as np
import torch

from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.viewer.interactive import ViewerSession as JSession
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.core.camera import Camera, make_camera
from pathtracer_tpu_torch.scene.scene import SceneBuilder
from pathtracer_tpu_torch.viewer import interactive
from pathtracer_tpu_torch.viewer.interactive import ViewerSession, _ansi_frame
from test_torch_render import _assert_images_close
from test_viewer_textures import _scene as _jax_scene

torch.set_num_threads(1)

KW = dict(width=16, height=8, spp=2, max_depth=2, accel="brute",
          ray_chunk=128, scene="test")
CFG = RenderConfig(**KW)


def _scene():
    b = SceneBuilder()
    m = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -3), 1.0, m)
    cam = make_camera((0, 0, 1), (0, 0, -3), 60, 2.0, aperture=0,
                      focus_dist=4, device="cpu")
    return b.build(device="cpu"), cam


def test_viewer_accumulates_and_restarts():
    scene, cam = _scene()
    sess = ViewerSession(scene, cam, CFG, spp_per_frame=1, device="cpu")
    img1 = sess.step()
    assert img1.shape == (8, 16, 3)
    img2 = sess.step()
    assert sess.passes == 2
    # accumulation converges: frame 2 is the mean of two 1-spp passes
    assert not np.array_equal(img1, img2)

    moved = sess.handle_key("w", 0.1)
    assert moved and sess.passes == 0  # WASD restarts accumulation
    assert not sess.handle_key("x", 0.1)


def test_ansi_frame_shape():
    img = np.random.default_rng(0).random((8, 16, 3)).astype(np.float32)
    s = _ansi_frame(img)
    assert s.count("\n") == 3  # 8 rows -> 4 half-block lines


def test_frames_match_jax_session():
    """Three frames, a move, two more: each equal to the reference
    session's at the same seed (the port's scene and camera from the
    reference's arrays)."""
    js, jc = _jax_scene()
    from pathtracer_tpu_torch.convert import scene_from_jax_arrays
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    tc = Camera(*(torch.from_numpy(np.array(x)) for x in jc))
    ref = JSession(js, jc, JConfig(**KW), spp_per_frame=1)
    sess = ViewerSession(ts, tc, CFG, spp_per_frame=1, device="cpu")
    for key in (None, None, None, "a", None):
        if key:
            assert ref.handle_key(key, 0.25) and sess.handle_key(key, 0.25)
            np.testing.assert_array_equal(sess.cam.position.numpy(),
                                          np.asarray(ref.cam.position))
        _assert_images_close(sess.step(), ref.step())
        assert sess.passes == ref.passes


def test_run_viewer_headless(monkeypatch, capsys):
    """Without a TTY the viewer renders its frames and returns; the "bvh"
    route builds its tree once for every frame."""
    from pathtracer_tpu_torch.render import renderer
    builds = []
    build = renderer.build_lbvh
    monkeypatch.setattr(renderer, "build_lbvh",
                        lambda sc: builds.append(1) or build(sc))
    scene, cam = _scene()
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    assert interactive.run_viewer(scene, cam, CFG.replace(accel="bvh"),
                                  max_frames=3, device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("FPS") == 3 and "passes: 3" in out
    assert len(builds) == 1
