"""The reference judges an emission-lit render: the program's Cornell box
with next-event estimation, the sky off, textures and stratified jitter,
at 32 x 32 and depth 4, run through the driver and ``compare.check``
under ``bunny-128spp``'s limits. It comes out correct in passes of 2
samples (8 an image, 2 x 2 strata) and in the traced shape (one image of
``trace_passes`` x ``spp_per_pass`` samples, one stratum), and not
correct with a fault planted in the program (the light sample dropped,
the sky left on, stratification ignored) or with the TF32 control in the
program's place. The reference's scene rows equal the program's, and its
fuzzy-metal lobe pdf, which the Cornell box does not reach (its metal
has no fuzz), is the density of the directions it stands for.

Textures ignored (albedo 1) stays inside those limits: the two textured
spheres sit mostly inside the blocks, and take 2.5% of the camera rays'
first hits at 256 x 256 (the checker 0.8%, the marble 1.7%), so the fault
moves at most some 3% of the channels. Its test holds it to what the
comparison does see: at each of 13 seeds its ``off_share`` read 2.7 to
5.1 times the sound run's at the same seed."""
from __future__ import annotations

import itertools
import os
import time

import numpy as np
import pytest
import torch

from perfbench import calibrate, compare
from perfbench.run import ROOT, load_module

CORNELL = {"scene": "cornell", "scene_args": {"variant": "full"},
           "width": 32, "height": 32, "spp": 8, "max_depth": 4,
           "t_min": 0.001, "sky": False, "nee": True, "stratify": True,
           "accel": "auto", "ray_chunk": 16384}
TRAFFIC = {"driver": "passes", "spp_per_pass": 2, "trace_passes": 1}
LIMITS = "bunny-128spp"
SEED = 2147483659


@pytest.fixture(autouse=True)
def pass_clock(monkeypatch):
    """One second a reading of the clock: a window of 4.5 s holds the 4
    passes of one image."""
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("PT_CORNELL_DIR", raising=False)
    ticks = itertools.count(1000.0, 1.0)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


class NoCapture:
    def start(self):
        pass

    def sync(self):
        pass

    def stop(self):
        pass


def render(config, traced=False):
    """The driver's answers of one image at ``SEED``, taken at the
    compared pixels, and those pixels."""
    driver = load_module(os.path.join(ROOT, "perfbench", "drivers",
                                      "passes.py"), "test_cornell_driver")
    state = driver.setup(config, TRAFFIC, SEED, "cpu", traced)
    window = driver.measure(state, 4.5, NoCapture() if traced else None)
    pixels = compare.pixels_of(ROOT, LIMITS, config, SEED)
    return compare.take(window.answers, pixels), pixels


def check(config, taken, pixels):
    scene = compare.reference_scene(config, ROOT)
    return compare.check(ROOT, LIMITS, config, TRAFFIC, taken, pixels,
                         scene, "cpu")


@pytest.mark.parametrize("variant", ["full", "spheres"])
def test_reference_scene_rows_equal_the_programs(variant):
    from pathtracer_tpu_torch.scene.cornell import cornell_box
    plain = compare.reference_scene(
        {**CORNELL, "scene_args": {"variant": variant}}, ROOT)
    scene, _ = cornell_box(variant=variant, device="cpu")
    mat = scene.prim_mat.long()
    pairs = [(plain.ptype, scene.prim_type), (plain.v0, scene.v0),
             (plain.e1, scene.e1), (plain.e2, scene.e2),
             (plain.radius, scene.radius), (plain.normal, scene.tri_normal),
             (plain.mtype[plain.pmat], scene.mat_type[mat]),
             (plain.albedo[plain.pmat], scene.albedo[mat]),
             (plain.fuzz[plain.pmat], scene.fuzz[mat]),
             (plain.ir[plain.pmat], scene.ir[mat]),
             (plain.emit[plain.pmat], scene.emit[mat]),
             (plain.tex_id[plain.pmat], scene.tex_id[mat]),
             (plain.textures, scene.textures)]
    for ours, theirs in pairs:
        assert np.array_equal(np.asarray(ours), theirs.numpy())


@pytest.mark.parametrize("variant,traced", [("full", False), ("full", True),
                                            ("spheres", False)])
def test_sound_render_is_correct(variant, traced):
    config = {**CORNELL, "scene_args": {"variant": variant}}
    taken, pixels = render(config, traced)
    assert [a.samples for a in taken] == [2 if traced else 8]
    assert taken[0].spp == (2 if traced else 8)
    correct, checks = check(config, taken, pixels)
    assert correct, checks


def test_traced_answer_is_judged_on_its_own_strata():
    # the traced image's 2 samples take one stratum; judged on the
    # configuration's 8 (2 x 2 strata) it is not correct
    taken, pixels = render(CORNELL, traced=True)
    correct, checks = check(CORNELL, [a._replace(spp=None) for a in taken],
                            pixels)
    assert not correct, checks


def _no_light(*args, **kw):
    rec_p = args[1]
    return (torch.zeros_like(rec_p),
            torch.zeros(rec_p.shape[0], dtype=torch.bool))


def plant(monkeypatch, fault):
    from pathtracer_tpu_torch.render import integrator, lights, renderer
    from pathtracer_tpu_torch.scene import materials
    if fault == "light dropped":
        monkeypatch.setattr(lights, "direct_lighting", _no_light)
    elif fault == "sky on":
        trace = integrator.trace
        monkeypatch.setattr(integrator, "trace",
                            lambda *a, **kw: trace(*a, **{**kw, "sky": True}))
    elif fault == "textures ignored":
        monkeypatch.setattr(materials, "sample_texture",
                            lambda scene, tex_id, uv: torch.ones(
                                uv.shape[:-1] + (3,), device=uv.device))
    elif fault == "stratify ignored":
        monkeypatch.setattr(renderer, "_stratum_grid", lambda spp: 1)


@pytest.mark.parametrize("fault", ["light dropped", "sky on",
                                   "stratify ignored"])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    plant(monkeypatch, fault)
    taken, pixels = render(CORNELL)
    correct, checks = check(CORNELL, taken, pixels)
    assert not correct, checks


def test_textures_ignored_moves_the_comparison(monkeypatch):
    limits = compare.load_limits(ROOT, LIMITS)

    def numbers():
        taken, pixels = render(CORNELL)
        scene = compare.reference_scene(CORNELL, ROOT)
        expected = [compare.reference_rows(
            CORNELL, scene, pixels, a.seed, a.samples,
            TRAFFIC["spp_per_pass"], "cpu", spp=a.spp) for a in taken]
        return compare.numbers(taken, expected, limits["off_at"])
    sound = numbers()
    plant(monkeypatch, "textures ignored")
    broken = numbers()
    assert broken["off_share"] > 2.0 * sound["off_share"], (sound, broken)
    assert broken["mean_abs_diff"] > 2.0 * sound["mean_abs_diff"], (
        sound, broken)


def test_control_is_not_correct():
    scene = compare.reference_scene(CORNELL, ROOT)
    pixels = compare.pixels_of(ROOT, LIMITS, CORNELL, SEED)
    answers = [compare.Taken(SEED, CORNELL["spp"], None, None,
                             CORNELL["spp"])]
    got = calibrate.control_answers(CORNELL, TRAFFIC, scene, answers, pixels,
                                    "cpu")
    expected = [compare.reference_rows(CORNELL, scene, pixels, SEED,
                                       CORNELL["spp"],
                                       TRAFFIC["spp_per_pass"], "cpu")]
    limits = compare.load_limits(ROOT, LIMITS)
    correct, checks = compare.judge(
        compare.numbers(got, expected, limits.get("off_at")), limits)
    assert not correct, checks


@pytest.mark.parametrize("fuzz", [0.05, 0.3, 0.9])
def test_metal_lobe_pdf_is_the_density_of_the_fuzzed_mirror_direction(fuzz):
    # the pdf depends on b = w.r alone: it integrates to one over the
    # sphere, and matches a histogram of b over sampled lobe directions
    from perfbench.reference import render
    r = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)

    def pdf(b):
        w = torch.stack([torch.sqrt(1.0 - b * b), torch.zeros_like(b), b],
                        dim=-1)
        return render.metal_lobe_pdf(w, r, torch.tensor(fuzz,
                                                        dtype=torch.float64))
    b = torch.linspace(-1.0, 1.0, 2_000_001, dtype=torch.float64)
    assert float(torch.trapezoid(pdf(b), b)) * 2 * render.PI == \
        pytest.approx(1.0, abs=2e-3)
    g = torch.Generator().manual_seed(7)
    u = torch.rand(3, 400_000, generator=g, dtype=torch.float64)
    ball = render.on_sphere(u[0], u[1]) * u[2, :, None] ** (1.0 / 3.0)
    v = r + fuzz * ball
    cos = v[:, 2] / torch.sqrt((v * v).sum(-1))
    lo = float(cos.min())
    edges = torch.linspace(lo, 1.0, 21, dtype=torch.float64)
    counts = torch.histc(cos, bins=20, min=lo, max=1.0)
    for i in range(20):
        bb = torch.linspace(float(edges[i]), float(edges[i + 1]), 2001,
                            dtype=torch.float64)
        want = 400_000 * 2 * render.PI * float(torch.trapezoid(pdf(bb), bb))
        assert abs(float(counts[i]) - want) < 5 * want ** 0.5 + 5
