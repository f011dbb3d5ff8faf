"""The reference's rows of the existing cells at the sizes of
``test_pb_correct.SMALL``, the program's side and the TF32 control's,
bit-equal to those of the reference before it learnt the sky switch,
next-event estimation, textures and stratified jitter: what it gained is
opt-in. The digests are sha256 of the float32 rows (torch 2.13 on the
CPU; another build may round a transcendental otherwise)."""
from __future__ import annotations

import hashlib
import os

import pytest

from perfbench import compare
from perfbench.run import ROOT, find_cell, load_json
from perfbench.tests.test_pb_correct import SEED, SMALL

DIGESTS = {
    ("bunny-128spp", "fp32"):
        "de4ce72da92c35d46253e402d17fdf98314f03ee219c8ef4ebebad28c3231a66",
    ("bunny-128spp", "tf32"):
        "9ad15d77ca002a4e842563c261c8b77ca7b8de8505560bd13755ec0854097c8d",
    ("rtow-100spp", "fp32"):
        "4ef0fa21329fcc63f203950f96909f9548c4e8287efa2710efcabb0d624521ff",
    ("rtow-100spp", "tf32"):
        "23577d94b18c5285ecca45357d2eac540f351613dbab64eb69e11e736db086ac",
}


@pytest.mark.parametrize("workload,precision", sorted(DIGESTS))
def test_reference_rows_as_pinned(workload, precision):
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, traffic = find_cell(spec, workload)
    config = {**config, **SMALL[workload][0]}
    scene = compare.reference_scene(config, ROOT)
    pixels = compare.pixels_of(ROOT, workload, config, SEED)
    rows = compare.reference_rows(config, scene, pixels, SEED,
                                  config["spp"], traffic["spp_per_pass"],
                                  "cpu", precision)
    digest = hashlib.sha256(rows.contiguous().numpy().tobytes()).hexdigest()
    assert digest == DIGESTS[workload, precision]
