"""The comparison that decides ``correct``, at a size a CPU run holds: each
cell run end to end on the program's plain twins, its card check skipped
and its window on a clock that ticks one second a pass, comes out
correct; with the timed path broken underneath (a pass that leaves the
framebuffer as it was, half of a pass's rays standing in for the other
half, every other pixel's radiance altered where a pass produces it) it
comes out not correct; and so does the control, the reference computed
in TF32 put in the program's place. The cells run on one card, so there
is no exchange between cards to leave out."""
from __future__ import annotations

import itertools
import os
import time

import pytest

from perfbench import calibrate, compare
from perfbench.run import ROOT, find_cell, load_json, run_cell

SMALL = {"bunny-128spp": ({"width": 32, "height": 18, "spp": 16}, 2.5),
         "rtow-100spp": ({"width": 32, "height": 18, "spp": 8}, 6.5)}
SEED = 2147483659


@pytest.fixture
def pass_clock(monkeypatch):
    monkeypatch.chdir(ROOT)
    ticks = itertools.count(1000.0, 1.0)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


def run_small(workload):
    override, seconds = SMALL[workload]
    return run_cell(workload, SEED, seconds, False, device="cpu",
                    config_override=override)


def break_passes(monkeypatch, fault):
    from pathtracer_tpu_torch.render import renderer
    monkeypatch.setattr(renderer, "render_sum", calibrate.faulty_render_sum(
        renderer.render_sum, fault))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload, pass_clock):
    result = run_small(workload)
    assert result["attempted"] >= 2
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", calibrate.FAULTS)
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_broken_pass_is_not_correct(workload, fault, pass_clock,
                                    monkeypatch):
    break_passes(monkeypatch, fault)
    result = run_small(workload)
    assert result["attempted"] >= 2
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(workload):
    override, _ = SMALL[workload]
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, traffic = find_cell(spec, workload)
    config = {**config, **override}
    scene = compare.reference_scene(config, ROOT)
    pixels = compare.pixels_of(ROOT, workload, config, SEED)
    answers = [compare.Taken(SEED, config["spp"], None, None)]
    got = calibrate.control_answers(config, traffic, scene, answers, pixels,
                                    "cpu")
    expected = [compare.reference_rows(config, scene, pixels, SEED,
                                       config["spp"],
                                       traffic["spp_per_pass"], "cpu")]
    limits = compare.load_limits(ROOT, workload)
    correct, checks = compare.judge(
        compare.numbers(got, expected, limits.get("off_at")), limits)
    assert not correct, checks
