"""A later change adds a configuration, a traffic mix, a driver and a
metric as files of their own plus entries in ``BENCHMARK.json``, and the
harness finds each by name without an edit to a file it already has
(checked on a copy)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

from perfbench.run import ROOT

PROBE = textwrap.dedent("""
    import json, os
    from types import SimpleNamespace
    from perfbench import compare, run
    spec = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    cell, config, traffic = run.find_cell(spec, "extra.cell")
    driver = run.load_module(os.path.join(
        run.ROOT, "perfbench", "drivers", traffic["driver"] + ".py"), "d")
    names = [m["name"] for m in run.metrics_of(spec, cell, True)]
    reader = run.load_module(os.path.join(
        run.ROOT, "perfbench", "metrics", "extra.metric.py"), "m")
    scene = compare.reference_scene(config, run.ROOT)
    print(json.dumps({
        "config": config["marker"], "driver": driver.hello(),
        "traced": names, "untraced": [
            m["name"] for m in run.metrics_of(spec, cell, False)],
        "read": reader.read(SimpleNamespace(x=41)),
        "limits": compare.load_limits(run.ROOT, "extra.cell")["pixels"],
        "prims": int(len(scene.ptype))}))
""")


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    pb = tmp_path / "perfbench"
    shutil.copytree(os.path.join(ROOT, "perfbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}

    (pb / "configs" / "extra.json").write_text(json.dumps({
        "marker": "extra-config", "scene": "extra_scene", "scene_args": {}}))
    (pb / "traffic" / "extra-mix.json").write_text(json.dumps({
        "driver": "extra_driver"}))
    (pb / "drivers" / "extra_driver.py").write_text(
        "def hello():\n    return 'extra-driver'\n")
    (pb / "metrics" / "extra.metric.py").write_text(
        "def read(run):\n    return run.x + 1\n")
    (pb / "limits" / "extra.cell.json").write_text(json.dumps({
        "pixels": 7, "mean_abs_diff": 0.1, "rel_sum_diff": 0.1,
        "nonfinite": 0}))
    (pb / "reference" / "scenes" / "extra_scene.py").write_text(
        textwrap.dedent("""
            from perfbench.reference.scenes.plain import LAMBERTIAN, Recipe
            def build(cfg, root):
                r = Recipe()
                r.sphere((0, 0, 0), 1.0, r.material(LAMBERTIAN, (1, 1, 1)))
                return r.build({})
        """))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "extra", "source": "a test",
                            "file": "perfbench/configs/extra.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "extra.cell", "config": "extra",
                              "traffic": "extra-mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "extra.metric", "unit": "n",
                              "better": "lower", "source": "program_counter",
                              "layer": "device", "moves": "msamples_per_s",
                              "workloads": ["extra.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"config": "extra-config", "driver": "extra-driver",
                   "traced": ["extra.metric"],
                   "untraced": ["msamples_per_s", "setup_s"],
                   "read": 42, "limits": 7, "prims": 1}
    # nothing the benchmark had was edited
    for path, data in before.items():
        assert path.read_bytes() == data, path
