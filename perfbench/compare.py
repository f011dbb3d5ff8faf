"""What decides ``correct``: the window's answers against the plain
reference (``perfbench/reference``), at sampled pixels.

The pixels are drawn from the run's seed (``pixels`` of them, the cell's
limits file says how many). For every image the window touched, the
reference renders those pixels at the image's seed, as many samples as
the framebuffer holds, pass by pass as the renderer sums them, with the
configuration's ``sky`` (default on), ``nee`` (default off) and
``stratify`` (default off; the strata of the spp that the image's
renderer was built for, which the driver records on the answer). Numbers
compared, each against the cell's limit (``perfbench/limits/<cell>.json``):

- ``mean_abs_diff``: the mean over the sampled channels of every answer of
  |program - reference| of the displayed value, sqrt(mean) of the
  framebuffer (the finished image where the image finished);
- ``rel_sum_diff``: |sum of the program's framebuffer rows - the
  reference's| / the reference's, over every answer;
- ``off_share``: the share of those channels whose |program - reference|
  exceeds the limits file's ``off_at``: a path that a near tie flips
  moves a pixel by a share of one sample, a pixel that shows another's
  radiance moves by the difference of the two, though that keeps the sum
  and, among close neighbours, much of the mean;
- ``nonfinite``: non-finite values among the program's (limit 0).

A number is judged where the limits file gives it a limit. A run with no
answer is not correct.
"""
from __future__ import annotations

import importlib
import os
from typing import NamedTuple, Optional

import numpy as np

# keys of a limits file that are settings, not limits
SETTINGS = ("pixels", "off_at")


def sample_pixels(seed: int, num_pixels: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = min(n, num_pixels)
    return np.sort(rng.choice(num_pixels, size=n, replace=False))


class Taken(NamedTuple):
    """An answer's values at the compared pixels, on the host."""
    seed: int
    samples: int
    framebuffer: object            # (P, 3) rows
    image: object                  # (P, 3) finished values, or None
    spp: Optional[int] = None      # the spp its renderer was built for


def take(answers, pixels):
    """The answers' :class:`Taken` values at ``pixels``."""
    import torch
    idx = torch.as_tensor(pixels, dtype=torch.int64)
    out = []
    for a in answers:
        fb = a.framebuffer.detach().cpu()[idx]
        img = None
        if a.image is not None:
            img = a.image.detach().cpu().reshape(-1, 3)[idx]
        out.append(Taken(a.seed, a.samples, fb, img, a.spp))
    return out


def reference_scene(config: dict, root: str):
    recipe = importlib.import_module(
        f"perfbench.reference.scenes.{config['scene']}")
    return recipe.build(config, root)


def reference_rows(config: dict, scene, pixels, seed: int, samples: int,
                   pass_spp: int, device, precision: str = "fp32",
                   spp: Optional[int] = None):
    """The reference's framebuffer rows; ``spp`` is the spp the image's
    renderer was built for (default: the configuration's)."""
    from perfbench.reference.render import render_pixels
    w, h = config["width"], config["height"]
    stratify = (spp or config["spp"]) if config.get("stratify") else None
    return render_pixels(scene, pixels, w, h,
                         min(config["ray_chunk"], w * h), seed, samples,
                         pass_spp, config["max_depth"], config["t_min"],
                         device, precision, sky_on=config.get("sky", True),
                         nee=config.get("nee", False),
                         stratify_spp=stratify)


def abs_diffs(taken, expected):
    """(|program - reference| of the displayed value over every sampled
    channel of every answer, the program's framebuffer sum, the
    reference's, the program's non-finite values) of program rows
    ``taken`` against reference framebuffer rows ``expected`` (one (P, 3)
    tensor per answer); the first is None where there is no answer."""
    import torch
    diffs, prog_sum, ref_sum, nonfinite = [], 0.0, 0.0, 0
    for (_, samples, fb, img, *_), ref in zip(taken, expected):
        ref = ref.cpu().double()
        fb = fb.double()
        shown = img.double() if img is not None else torch.sqrt(
            torch.clamp(fb, min=0.0) / samples)
        nonfinite += int((~torch.isfinite(shown)).sum()
                         + (~torch.isfinite(fb)).sum())
        ref_shown = torch.sqrt(torch.clamp(ref, min=0.0) / samples)
        diffs.append((shown - ref_shown).abs().flatten())
        prog_sum += float(fb.sum())
        ref_sum += float(ref.sum())
    if not diffs:
        return None, prog_sum, ref_sum, nonfinite
    d = torch.nan_to_num(torch.cat(diffs), nan=1e30)
    return d, prog_sum, ref_sum, nonfinite


def numbers(taken, expected, off_at=None) -> dict:
    """The compared numbers of program rows ``taken`` against reference
    framebuffer rows ``expected`` (one (P, 3) tensor per answer);
    ``off_share`` where ``off_at`` is given."""
    d, prog_sum, ref_sum, nonfinite = abs_diffs(taken, expected)
    if d is None:
        return {}
    out = {"mean_abs_diff": float(d.mean()),
           "rel_sum_diff": abs(prog_sum - ref_sum) / max(ref_sum, 1e-30),
           "nonfinite": nonfinite}
    if off_at is not None:
        out["off_share"] = float((d > off_at).double().mean())
    return out


def judge(values: dict, limits: dict):
    """(correct, checks): every number that ``limits`` names at or under
    its limit."""
    checks = {name: {"value": values.get(name), "limit": limit}
              for name, limit in limits.items() if name not in SETTINGS}
    correct = bool(values) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return correct, checks


def load_limits(root: str, workload: str) -> dict:
    import json
    with open(os.path.join(root, "perfbench", "limits",
                           f"{workload}.json")) as f:
        return json.load(f)


def pixels_of(root: str, workload: str, config: dict, seed: int):
    """The pixels a run at ``seed`` compares."""
    return sample_pixels(seed, config["width"] * config["height"],
                         load_limits(root, workload)["pixels"])


def check(root: str, workload: str, config: dict, traffic: dict, taken,
          pixels, scene, device):
    """(correct, checks) of the taken answers against the reference
    rendering of ``scene`` (:func:`reference_scene`)."""
    limits = load_limits(root, workload)
    expected = [reference_rows(config, scene, pixels, a.seed, a.samples,
                               traffic["spp_per_pass"], device, spp=a.spp)
                for a in taken]
    return judge(numbers(taken, expected, limits.get("off_at")), limits)
