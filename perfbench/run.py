"""Run one cell of the benchmark of ``pathtracer_tpu_torch`` on the card.

    python3 -m perfbench.run --workload bunny-128spp --seed 7 \\
        --seconds 30 --trace 0

The cell is found by name in ``BENCHMARK.json``: its configuration file,
its traffic mix ``perfbench/traffic/<traffic>.json``, the mix's driver
``perfbench/drivers/<driver>.py`` and each metric's reader
``perfbench/metrics/<metric>.py``. With ``--trace 0`` the run reports the
cell's end-to-end metrics; with ``--trace 1`` it profiles the mix's
traced passes and reports the per-layer metrics, ``busy_s``, ``window_s``
and a ``breakdown``. Both compare the window's output with the plain
reference once the window has closed (``perfbench/compare.py``), print
each number compared beside its limit as the last lines on standard
error, and print one JSON object as the last line on standard output.

The run fails with no result when the card or the program is missing, and
when ``jax``, ``jaxlib``, ``flax`` or ``pathtracer_tpu`` is loaded.
Kernel and build caches stay in the checkout.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pathtracer_tpu"})


class RunError(Exception):
    """A run that cannot give a result; the message says why."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module (names may hold dots and
    dashes)."""
    if not os.path.exists(path):
        raise RunError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(spec: dict, workload: str):
    """(cell, configuration, traffic) of a workload's name."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(ROOT, "perfbench", "traffic",
                                     f"{cell['traffic']}.json"))
    return cell, config, traffic


def metrics_of(spec: dict, cell: dict, traced: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end ones,
    or with ``traced`` its per-layer ones."""
    name = cell["name"]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def check_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: torch.cuda.is_available() is "
                       "False")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} CUDA devices, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", config_override=None) -> dict:
    """One run of a cell; returns the result object. ``device="cpu"``
    runs the program's plain twins (tests only), with no card check and
    no device numbers; ``config_override`` shrinks the configuration."""
    import torch

    from perfbench import compare, trace
    from perfbench.reference.scenes.plain import SPHERE
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic = find_cell(spec, workload)
    config = {**config, **(config_override or {})}
    on_card = device.startswith("cuda")
    if on_card:
        check_cards(cell["chips"])
    driver = load_module(os.path.join(ROOT, "perfbench", "drivers",
                                      f"{traffic['driver']}.py"),
                         f"perfbench_driver_{traffic['driver']}")

    setup_start = time.perf_counter()
    state = driver.setup(config, traffic, seed, device, traced)
    setup_s = time.perf_counter() - START
    phases = {"before the driver": setup_start - START,
              **getattr(state, "setup_phases", {})}
    capture = trace.Capture() if traced else None
    t = time.perf_counter()
    window = driver.measure(state, seconds, capture)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"set-up {setup_s:.3f} s ("
        f"{', '.join(f'{k} {v:.3f} s' for k, v in phases.items())}); "
        f"window {window.seconds:.3f} s, {window.passes} passes of "
        f"{', '.join(f'{x:.3f}' for x in window.pass_s)} s; measure "
        f"{time.perf_counter() - t:.3f} s")

    pixels = compare.pixels_of(ROOT, workload, config, seed)
    taken = compare.take(window.answers, pixels)
    del state, window.answers
    if on_card:
        torch.cuda.empty_cache()

    scene = compare.reference_scene(config, ROOT)
    spheres = int((scene.ptype == SPHERE).sum())
    run = SimpleNamespace(setup_s=setup_s, window=window,
                          trace=capture.summary if traced else None,
                          harness_syncs=capture.syncs if traced else 0,
                          spheres=spheres,
                          triangles=len(scene.ptype) - spheres)
    metrics = {}
    for m in metrics_of(spec, cell, traced):
        reader = load_module(os.path.join(ROOT, "perfbench", "metrics",
                                          f"{m['name']}.py"),
                             f"perfbench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t = time.perf_counter()
    correct, checks = compare.check(ROOT, workload, config, traffic, taken,
                                    pixels, scene, device)
    log(f"reference of {len(taken)} image(s) at {len(pixels)} pixels "
        f"{time.perf_counter() - t:.3f} s")
    result = {"correct": correct, "attempted": window.passes, "failed": 0,
              "metrics": metrics}
    if on_card:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(0),
                            "count": cell["chips"],
                            "memory_peak_bytes": memory_peak}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if traced:
        s = run.trace
        log(f"trace: profiler exit {capture.reduce_s[0]:.3f} s, reduce "
            f"{capture.reduce_s[1]:.3f} s; {len(s.device)} device intervals,"
            f" {trace.launches(s.runtime)} launch calls, "
            f"{trace.syncs(s.runtime)} sync calls ({capture.syncs} the "
            f"harness's); {s.query_calls} query calls with "
            f"{len(s.query_device)} device intervals; runtime calls "
            f"{sorted(s.runtime.items())}")
        busy = trace.busy_ns(run.trace) / 1e9
        result["device"].update(busy_s=busy, window_s=run.trace.window_s)
        result["breakdown"] = trace.breakdown(run.trace)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # configurations name their files relative to the checkout's root
    os.chdir(ROOT)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except (RunError, ImportError) as e:
        log(str(e))
        return 2
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}; no result")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} value={c['value']!r} limit={c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
