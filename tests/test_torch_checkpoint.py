"""The port's long-render utilities against the JAX reference: checkpointed
pass renders (``utils/checkpoint``), the timing helpers
(``utils/metrics``) and the CLI's pass route.

Tolerances: a resumed render equals an uninterrupted one in passes of the
same size bit for bit (the same additions in the same order); a pass
render differs from a one-pass render only in the order of its float32
additions, atol 1e-6 (the reference's own bar, tests/test_utils.py); the
port's pass render against the reference's uses the render tolerance of
tests/test_torch_render.py (>= 99% of channels within 1e-4, mean |diff|
<= 1e-3: the sweeps differ at ulp level).
"""
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import checkpoint as jcheckpoint
from pathtracer_tpu.utils import metrics as jmetrics
from pathtracer_tpu_torch import __main__ as tcli
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.render.renderer import make_renderer, render_image
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils import checkpoint, metrics

torch.set_num_threads(1)

KW = dict(width=16, height=8, spp=4, max_depth=3, accel="brute",
          ray_chunk=128, scene="test", seed=11)
CFG = TConfig(**KW)


def _test_world():
    return tworlds.test_world(device="cpu")


def _passes(cfg, path, n, **kw):
    scene, cam = _test_world()
    return checkpoint.render_with_checkpoints(scene, cam, cfg, path,
                                              spp_per_chunk=n, device="cpu",
                                              **kw)


def test_checkpoint_resume_bit_identical(tmp_path):
    """Stopped after its first pass and resumed, a render equals the
    uninterrupted render in passes of the same size, bit for bit."""
    full = _passes(CFG, str(tmp_path / "render.ckpt.npz"), 2).numpy()
    ck = str(tmp_path / "partial.ckpt.npz")

    def stop_after_first(done, total):
        if done >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _passes(CFG, ck, 2, progress=stop_after_first)
    state = checkpoint.load_render_state(ck, CFG, _test_world()[0].num_prims)
    assert state is not None and state[1] == 2
    seen = []
    resumed = _passes(CFG, ck, 2, progress=lambda d, t: seen.append(d))
    assert seen == [4]                  # one pass left
    np.testing.assert_array_equal(resumed.numpy(), full)


def test_checkpoint_matches_plain_render(tmp_path):
    """The pass render equals the one-pass render up to the order of its
    float32 additions."""
    scene, cam = _test_world()
    via_passes = _passes(CFG, str(tmp_path / "r.ckpt.npz"), 2).numpy()
    plain = render_image(scene, cam, CFG, device="cpu").numpy()
    np.testing.assert_allclose(via_passes, plain, atol=1e-6)
    assert not np.array_equal(via_passes, np.zeros_like(via_passes))


def test_checkpoint_rejects_mismatched_config(tmp_path):
    ck = str(tmp_path / "r.ckpt.npz")
    _passes(CFG, ck, 4)
    n = _test_world()[0].num_prims
    assert checkpoint.load_render_state(ck, CFG, n)[1] == 4
    assert checkpoint.load_render_state(ck, CFG.replace(seed=99), n) is None
    assert checkpoint.load_render_state(ck, CFG, n + 1) is None
    assert checkpoint.load_render_state(str(tmp_path / "none.npz"), CFG,
                                        n) is None


def test_fingerprint_and_container_match_reference(tmp_path):
    """The same config fingerprints alike in both packages, and each
    package resumes from the other's checkpoint file."""
    for kw in (KW, dict(KW, nee=True, sampler="sobol", rr=True), {}):
        assert checkpoint._cfg_fingerprint(TConfig(**kw), 7) == \
            jcheckpoint._cfg_fingerprint(JConfig(**kw), 7)
    acc = np.random.default_rng(0).random((128, 3), dtype=np.float32)
    ck = str(tmp_path / "j.npz")
    jcheckpoint.save_render_state(ck, acc, 2, JConfig(**KW), 3)
    got, nxt = checkpoint.load_render_state(ck, CFG, 3)
    assert nxt == 2
    np.testing.assert_array_equal(got, acc)
    checkpoint.save_render_state(ck, torch.from_numpy(acc), 3, CFG, 3)
    got, nxt = jcheckpoint.load_render_state(ck, JConfig(**KW), 3)
    assert nxt == 3
    np.testing.assert_array_equal(got, acc)


def test_pass_render_matches_reference(tmp_path):
    """The port's pass render of the test world against the reference's
    ``render_with_checkpoints`` at the same seed and pass size."""
    js, jc = jworlds.test_world()
    ref = jcheckpoint.render_with_checkpoints(js, jc, JConfig(**KW), None,
                                              spp_per_chunk=2)
    img = _passes(CFG, None, 2).numpy()
    assert img.shape == ref.shape
    diff = np.abs(img - ref)
    assert (diff <= 1e-4).mean() >= 0.99, (diff <= 1e-4).mean()
    assert diff.mean() <= 1e-3, diff.mean()


def test_pass_render_stats_and_renderer_checks():
    """With a renderer made ``with_stats`` the executed counts come back
    summed over the passes, equal to the one-pass render's; a renderer of
    another config and a pass size below 1 raise; the "bvh" route renders
    in passes too, equal to brute force."""
    scene, cam = _test_world()
    render = make_renderer(CFG, "cpu", with_stats=True)
    img, stats = _passes(CFG, None, 2, renderer=render)
    _, stats1 = render(scene, cam)
    assert stats == pytest.approx(stats1) and stats[0] > 0
    with pytest.raises(ValueError, match="another config"):
        _passes(CFG.replace(spp=2), None, 2, renderer=render)
    with pytest.raises(ValueError, match="positive"):
        _passes(CFG, None, 0)
    assert torch.equal(_passes(CFG.replace(accel="bvh"), None, 2),
                       _passes(CFG.replace(accel="brute"), None, 2))


@pytest.mark.parametrize("backend", ["npz", "torch"])
def test_fit_state_roundtrip(tmp_path, backend):
    save, load = {"npz": (checkpoint.save_fit_state,
                          checkpoint.load_fit_state),
                  "torch": (checkpoint.save_fit_state_torch,
                            checkpoint.load_fit_state_torch)}[backend]
    p = str(tmp_path / "fit.state")
    assert load(p) is None
    albedo = torch.full((3, 3), 0.5, requires_grad=True)
    save(p, {"albedo": albedo, "emit": np.arange(6.0).reshape(2, 3)}, 7,
         [1.0, 0.5])
    loaded, step, hist = load(p)
    assert step == 7 and hist == [1.0, 0.5]
    np.testing.assert_array_equal(loaded["albedo"], albedo.detach().numpy())
    np.testing.assert_array_equal(loaded["emit"],
                                  np.arange(6.0).reshape(2, 3))
    if backend == "npz":
        # the reference reads the port's npz, as the port reads its own
        j_loaded, j_step, _ = jcheckpoint.load_fit_state(p)
        assert j_step == 7
        np.testing.assert_array_equal(j_loaded["albedo"], loaded["albedo"])


def test_mrays_per_s_matches_reference():
    for args in ((1000, 10, 5, 0.05), (800 * 450, 100, 50, 3.7),
                 (1, 1, 1, 0.0)):
        assert metrics.mrays_per_s(*args) == jmetrics.mrays_per_s(*args)
    assert metrics.mrays_per_s(1000, 10, 5, 0.05) == 1.0


def test_trace_context_writes_a_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with metrics.trace_context(log_dir):
        torch.ones(64).sum()
    path = os.path.join(log_dir, metrics.TRACE_FILE)
    assert os.path.getsize(path) > 0
    with metrics.trace_context(None):
        pass
    assert os.listdir(log_dir) == [metrics.TRACE_FILE]


def test_cli_pass_flags_match_reference():
    """--checkpoint and --spp-per-pass parse with the reference's
    defaults; the CLI's default render (100 spp) takes the pass route."""
    import pathtracer_tpu.__main__ as jcli
    for argv in ([], ["--checkpoint", "r.npz", "--spp-per-pass", "3"]):
        port = vars(tcli.build_parser().parse_args(argv))
        ref = vars(jcli.build_parser().parse_args(argv))
        assert (port["checkpoint"], port["spp_per_pass"]) == \
            (ref["checkpoint"], ref["spp_per_pass"])
    args = tcli.build_parser().parse_args([])
    assert args.spp_per_pass == 8 and args.checkpoint is None
    assert args.spp > args.spp_per_pass


def _run_cli(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tcli.main(argv)
    return rc, out.getvalue()


def test_cli_checkpoint_resumes_to_the_same_png(tmp_path, monkeypatch):
    """An interrupted ``--checkpoint`` run, run again, resumes from its
    last pass and writes the PNG of an uninterrupted run; without a
    checkpoint, more spp than --spp-per-pass also takes the pass route."""
    base = ["--scene", "test", "--width", "16", "--height", "8", "--spp",
            "3", "--max-depth", "2", "--ray-chunk", "128", "--device", "cpu",
            "--spp-per-pass", "1"]
    full, part = tmp_path / "full.png", tmp_path / "part.png"
    rc, text = _run_cli(base + ["--checkpoint", str(tmp_path / "f.npz"),
                                "-o", str(full)])
    assert rc == 0 and "  3/3 spp" in text
    rc, text = _run_cli(base + ["-o", str(tmp_path / "n.png")])
    assert rc == 0 and "  1/3 spp" in text       # passes, no checkpoint
    assert (tmp_path / "n.png").read_bytes() == full.read_bytes()

    ck = str(tmp_path / "p.npz")
    save = checkpoint.save_render_state

    def save_then_stop(path, acc, next_sample, *a):
        save(path, acc, next_sample, *a)
        if next_sample == 1:
            raise KeyboardInterrupt
    monkeypatch.setattr(checkpoint, "save_render_state", save_then_stop)
    with pytest.raises(KeyboardInterrupt):
        _run_cli(base + ["--checkpoint", ck, "-o", str(part)])
    assert not part.exists()
    monkeypatch.setattr(checkpoint, "save_render_state", save)
    rc, text = _run_cli(base + ["--checkpoint", ck, "-o", str(part)])
    assert rc == 0 and "  1/3 spp" not in text and "  2/3 spp" in text
    assert part.read_bytes() == full.read_bytes()
