"""Readings for a cell's limits (``perfbench/limits/<cell>.json``), on the
card, in one process: the program set up once, then for each seed a
window of the run's length and its comparison with the reference; the
control, the reference computed in TF32 (``precision="tf32"``) put in the
program's place for the same images, pixels and samples; the program with
a fault planted in its timed path (:data:`FAULTS`); and the traced run's
image, rendered as a ``--trace 1`` run renders it, without the profiler.

    python3 -m perfbench.calibrate --workload bunny-128spp \\
        --seeds 11,12,13 --control-seeds 11,12,13 \\
        --faults half,altered --fault-seeds 21,22,23 \\
        --traced-seeds 31,32,33 --seconds 51

Prints one JSON line per seed and side, the numbers ``compare.numbers``
gives and the spread of the differences, and writes them all to ``--out``
when given.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

from perfbench import compare
from perfbench.run import ROOT, find_cell, load_json, load_module

# faults planted where a pass is produced (``renderer.render_sum``):
# "unchanged", every other pass leaves the framebuffer as it was; "half",
# each odd pixel of a pass takes the radiance of the pixel before it;
# "altered", every other pixel's radiance times 1.5
FAULTS = ("unchanged", "half", "altered")


def faulty_render_sum(real, fault: str):
    """``real`` (``renderer.render_sum``) with ``fault`` planted."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
    calls = itertools.count()

    def broken(*args, **kw):
        part, stats = real(*args, **kw)
        part = part.clone()
        if fault == "unchanged" and next(calls) % 2 == 1:
            part.zero_()
        elif fault == "half":
            part[1::2] = part[0::2]
        elif fault == "altered":
            part[::2] *= 1.5
        return part, stats
    return broken


def control_answers(config: dict, traffic: dict, scene, answers, pixels,
                    device):
    """The control's answers: for each answer of ``answers``
    (``compare.Taken``), the reference in TF32 at ``pixels`` at its seed,
    samples and spp."""
    return [compare.Taken(a.seed, a.samples, compare.reference_rows(
        config, scene, pixels, a.seed, a.samples, traffic["spp_per_pass"],
        device, precision="tf32", spp=a.spp).cpu(), None, a.spp)
        for a in answers]


def spread(taken, expected) -> dict:
    """Quantiles of |program - reference| and the shares over a few
    thresholds: what a limit on another number would have to go by."""
    import torch
    d = compare.abs_diffs(taken, expected)[0].float()
    qs = (0.5, 0.9, 0.95, 0.99)
    q = torch.quantile(d, torch.tensor(qs))
    return {**{f"p{round(100 * k)}": float(v) for k, v in zip(qs, q)},
            "max": float(d.max()),
            **{f"share_over_{t:g}": float((d > t).double().mean())
               for t in (1e-4, 1e-3, 3e-3, 1e-2, 3e-2)}}


class NoProfiler:
    """The traced run's capture without the profiler: the same passes,
    each ended by a synchronise."""

    def start(self):
        pass

    def sync(self):
        import torch
        torch.cuda.synchronize()

    def stop(self):
        self.sync()


def ids(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--traced-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    import torch
    from pathtracer_tpu_torch.render import renderer
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, traffic = find_cell(spec, args.workload)
    driver = load_module(os.path.join(ROOT, "perfbench", "drivers",
                                      f"{traffic['driver']}.py"),
                         "perfbench_driver")
    control = set(ids(args.control_seeds))
    runs = ([(s, None) for s in ids(args.seeds)]
            + [(s, f) for f in args.faults.split(",") if f
               for s in ids(args.fault_seeds)])
    traced = ids(args.traced_seeds)
    scene = compare.reference_scene(config, ROOT)
    off_at = compare.load_limits(ROOT, args.workload).get("off_at")
    real_render_sum = renderer.render_sum
    rows = []

    def read(state, seed, fault=None, capture=None):
        state.seed = seed
        if fault:
            renderer.render_sum = faulty_render_sum(real_render_sum, fault)
        try:
            window = driver.measure(state, args.seconds, capture)
        finally:
            renderer.render_sum = real_render_sum
        pixels = compare.pixels_of(ROOT, args.workload, config, seed)
        taken = compare.take(window.answers, pixels)
        del window.answers
        torch.cuda.empty_cache()
        t = time.perf_counter()
        expected = [compare.reference_rows(config, scene, pixels, a.seed,
                                           a.samples, traffic["spp_per_pass"],
                                           "cuda", spp=a.spp)
                    for a in taken]
        ref_s = time.perf_counter() - t
        side = ("traced" if capture else f"fault:{fault}" if fault
                else "program")
        sides = [(side, taken)]
        if side == "program" and seed in control:
            sides.append(("control", control_answers(
                config, traffic, scene, taken, pixels, "cuda")))
        for name, got in sides:
            row = dict(workload=args.workload, seed=seed, side=name,
                       passes=window.passes,
                       samples=[a.samples for a in got],
                       reference_s=ref_s,
                       **compare.numbers(got, expected, off_at),
                       spread=spread(got, expected))
            rows.append(row)
            print(json.dumps(row), flush=True)

    if runs:
        state = driver.setup(config, traffic, runs[0][0], "cuda", False)
        for seed, fault in runs:
            read(state, seed, fault)
        del state
    if traced:
        state = driver.setup(config, traffic, traced[0], "cuda", True)
        for seed in traced:
            read(state, seed, capture=NoProfiler())
        del state
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
