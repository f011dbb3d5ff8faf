"""The port's benches (``pathtracer_tpu_torch/bench.py`` and
``bench_scaling.py``) on the CPU, against the JAX package.

- The bench's one JSON line: the schema-2 keys, every rate null on the
  CPU, and ``executed_queries`` / ``shadow_queries`` equal to the JAX
  renderer's ``with_stats`` counts of the same render (exact: both count
  the same lanes of the same random streams); a missing card, a deadline
  and a signal each give ``"value": null`` with an ``error`` and exit 1.
- The scaling proxy: per-shard executed queries of both layouts equal to
  the JAX ``render_sum(..., with_stats=True)`` on the same shard
  selections (exact), summing to the unsharded count; the collective
  bytes it states equal the bytes the sharded renderer hands to
  ``dist.all_reduce`` under a process group.
"""
import functools
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.parallel import make_mesh as jmake_mesh
from pathtracer_tpu.parallel.sharded import _shard_plan as jplan
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene.worlds import get_world as jget_world
from pathtracer_tpu_torch import bench_scaling
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.parallel import make_mesh, make_sharded_renderer
from pathtracer_tpu_torch.parallel import sharded
from pathtracer_tpu_torch.scene.worlds import get_world

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA2 = {"metric", "value", "unit", "vs_baseline", "accel", "prims",
           "nominal_queries", "schema", "executed_queries", "shadow_queries",
           "executed_mrays_per_s", "pair_tests", "march_tflops"}
RATE_KEYS = ("value", "executed_mrays_per_s", "march_tflops", "march_mfu",
             "wall_s", "walls_s", "setup_s", "warmup_s", "peak_mem_mib")
TINY = ["--width", "32", "--height", "16", "--spp", "1", "--depth", "2",
        "--iters", "1", "--ray-chunk", "512"]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


def _json_lines(stdout):
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


def _bench(argv, timeout=300, **env):
    proc = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.bench", *argv],
        cwd=REPO, env=_env(**env), capture_output=True, text=True,
        timeout=timeout)
    return proc.returncode, _json_lines(proc.stdout), proc


@functools.lru_cache(maxsize=None)
def _jax_counts(scene, accel, width, height, spp, depth, chunk, seed):
    """(closest-hit, shadow) executed queries of the JAX renderer with
    stats on the bench's configuration (its scene rule: cornell and
    combined are lit by NEE, without sky)."""
    lit = scene in ("cornell", "combined")
    cfg = JConfig(width=width, height=height, spp=spp, max_depth=depth,
                  accel=accel, ray_chunk=chunk, scene=scene, sky=not lit,
                  nee=lit)
    jscene, jcam = jget_world(scene)
    render = jrenderer.make_renderer(cfg, with_bvh=False, with_stats=True)
    _, n_exec = render(jscene, None, jcam, seed)
    n_exec = np.asarray(n_exec)
    return int(n_exec[0]), int(n_exec[1])


@pytest.mark.parametrize("scene", ["test", "cornell"])
def test_bench_line_and_counts_match_jax(scene):
    rc, lines, proc = _bench(["--device", "cpu", "--scene", scene,
                              "--accel", "brute", *TINY])
    assert rc == 0 and len(lines) == 1, (proc.stdout, proc.stderr[-2000:])
    rec = lines[0]
    assert SCHEMA2 <= set(rec) and rec["schema"] == 2
    assert rec["metric"] == f"{scene}_forward_throughput"
    assert rec["unit"] == "Mrays/s" and rec["vs_baseline"] is None
    assert all(rec[k] is None for k in RATE_KEYS), rec
    assert rec["correct"] is True and rec["check"]["finite"]
    assert rec["accel"] == "brute" and rec["nominal_queries"] == 32 * 16 * 2
    assert rec["device"]["name"] == "cpu"
    # the timed render is seed 1 (the warm-up is seed 0)
    closest, shadow = _jax_counts(scene, "brute", 32, 16, 1, 2, 512, 1)
    assert (rec["executed_queries"], rec["shadow_queries"]) == (closest,
                                                                shadow)
    assert 0 < rec["executed_queries"] <= rec["nominal_queries"]
    assert (rec["shadow_queries"] > 0) == (scene == "cornell")
    assert rec["pair_tests"] == 0 and rec["launches"] == {
        "cluster_march": 0, "march_prep": 0, "dense_sweep": 0,
        "window_sweep": 0, "ray_uniforms": 0, "bvh_traverse": 0,
        "shade_bounce": 0, "shade_nee": 0, "shade_nee_finish": 0,
        "march_shadow": 0, "march_prep_twin": 0}


def test_bench_stamps_its_environment_knobs():
    """The line's ``env`` holds every PT_CLUSTER_* variable set (the port's
    knobs of how a render runs) and no other: the reference's PT_RNG_* and
    PT_SORT_* options, which the port does not read, are not stamped."""
    knobs = {"PT_CLUSTER_K": "32", "PT_CLUSTER_SORT": "0"}
    others = {"PT_RNG_HASH": "1", "PT_SORT_ONCE": "1"}
    stamped = {k: v for k, v in _env(**knobs, **others).items()
               if k.startswith("PT_CLUSTER_")}
    argv = ["--device", "cpu", "--scene", "cornell", "--accel", "cluster",
            "--width", "32", "--height", "16", "--spp", "1", "--depth", "3",
            "--iters", "1", "--ray-chunk", "512"]
    rc, lines, proc = _bench(argv, **knobs, **others)
    assert rc == 0 and len(lines) == 1, (proc.stdout, proc.stderr[-2000:])
    env = lines[0]["env"]
    assert env == stamped and knobs.items() <= env.items()
    assert not any(k.startswith(("PT_RNG_", "PT_SORT_", "PT_BENCH_"))
                   for k in env)


def test_bench_without_a_card_fails_at_once():
    t0 = time.monotonic()
    rc, lines, proc = _bench(["--scene", "test", *TINY],
                             CUDA_VISIBLE_DEVICES="")
    assert rc == 1 and len(lines) == 1, (proc.stdout, proc.stderr[-2000:])
    assert lines[0]["value"] is None
    assert "no CUDA device" in lines[0]["error"]
    assert not set(RATE_KEYS[1:]) & set(lines[0])
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("how", ["deadline", "signal"])
def test_bench_watchdog_prints_no_number(how):
    """A deadline or a signal kills the measured child and prints a null
    line with the reason, exit 1 (never an earlier run's number)."""
    env = _env(PT_BENCH_FAKE="sleep:30",
               PT_BENCH_BUDGET_S="2" if how == "deadline" else "600")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pathtracer_tpu_torch.bench"], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    started = proc.stderr.readline()
    assert started.startswith("bench: measuring in child"), started
    child_pid = int(started.split()[4])
    if how == "signal":
        proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=60)
    assert time.monotonic() - t0 < 25
    lines = _json_lines(out)
    assert proc.returncode == 1 and len(lines) == 1, (out, err[-2000:])
    assert lines[0]["value"] is None
    assert ("budget" if how == "deadline" else "signal 15") in \
        lines[0]["error"]
    # the child (killed with its process group) is gone
    for _ in range(50):
        try:
            os.kill(child_pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        pytest.fail(f"the bench's child {child_pid} outlived it")


def test_scaling_cpu_line():
    args = bench_scaling.build_parser().parse_args(
        ["--device", "cpu", "--scene", "test", "--accel", "brute",
         *TINY])
    lines = bench_scaling.run_scaling(args)
    assert len(lines) == 1
    rec = lines[0]
    assert rec["metric"] == "scaling" and rec["devices"] == 1
    assert rec["value"] is None and rec["efficiency"] is None
    # a 1x1 mesh at the plan's chunk (512 rays here): the bench's render
    assert rec["executed_queries"] == _jax_counts(
        "test", "brute", 32, 16, 1, 2, 512, 1)[0]


@pytest.mark.parametrize("mode", [[], ["--proxy"]])
def test_scaling_without_a_card_fails(mode, monkeypatch, tmp_path, capsys):
    """Neither mode falls back to the CPU: with no card and the CPU not
    asked for (no --device cpu, no --proxy-devices), each exits 1 at once,
    prints no line and writes no record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "proxy.json"
    assert bench_scaling.main([*mode, "--scene", "test", "--out", str(out),
                               *TINY]) == 1
    captured = capsys.readouterr()
    assert not _json_lines(captured.out) and not out.exists()
    assert "no CUDA device" in captured.err


def _jax_shard_counts(cfg_kw, n_dev, chunk, per_dev_chunks, seed=0):
    """The JAX bench_scaling proxy's per-shard executed queries, both
    layouts, with the JAX renderer's render_sum on the same selections."""
    jcfg = JConfig(**cfg_kw).replace(ray_chunk=chunk)
    jscene, jcam = jget_world(cfg_kw["scene"])
    rows, cols = jrenderer.padded_pixel_grid(jcfg, n_dev * per_dev_chunks
                                             * chunk)
    rs = np.asarray(rows).reshape(-1, chunk)
    cs = np.asarray(cols).reshape(-1, chunk)
    count = jax.jit(lambda r, c: jrenderer.render_sum(
        jscene, None, jcam, jax.random.PRNGKey(seed), r, c, jcfg, jcfg.spp,
        with_stats=True)[1][0])
    out = {}
    for interleave in (False, True):
        counts = []
        for d in range(n_dev):
            sel = ([k * n_dev + d for k in range(per_dev_chunks)]
                   if interleave else
                   list(range(d * per_dev_chunks, (d + 1) * per_dev_chunks)))
            counts.append(int(count(rs[sel].reshape(-1),
                                    cs[sel].reshape(-1))))
        out[interleave] = counts
    return out


@pytest.mark.parametrize("size", [(32, 16), (128, 72)])
def test_scaling_proxy_matches_jax(size, tmp_path):
    """On 8 CPU slots at 32x16 each slot renders one chunk, so the two
    layouts coincide; at 128x72 each renders two, and they differ."""
    w, h = size
    out = tmp_path / "proxy.json"
    args = bench_scaling.build_parser().parse_args(
        ["--proxy", "--proxy-devices", "cpux8", "--scene", "test",
         "--accel", "brute", "--width", str(w), "--height", str(h),
         "--spp", "1", "--depth", "2", "--out", str(out)])
    rec = bench_scaling.run_proxy(args)
    assert json.loads(out.read_text()) == rec
    chunk, per = rec["config"]["chunk"], rec["config"]["chunks_per_slot"]
    cfg_kw = dict(width=w, height=h, spp=1, max_depth=2, accel="brute",
                  scene="test", ray_chunk=w * h // 8)
    assert jplan(JConfig(**cfg_kw), jmake_mesh(jax.devices()[:8])) == \
        sharded._shard_plan(TConfig(**cfg_kw), make_mesh(["cpu"] * 8))
    assert per == (1 if size == (32, 16) else 2)
    ref = _jax_shard_counts(cfg_kw, 8, chunk, per)
    assert rec["per_shard_executed_queries_contiguous"] == ref[False]
    assert rec["per_shard_executed_queries"] == ref[True]
    assert rec["sums_match"] and sum(ref[True]) == sum(ref[False]) == \
        rec["unsharded_executed_queries"]
    if per > 1:
        assert ref[True] != ref[False]
    assert rec["imbalance_efficiency"] == pytest.approx(
        np.mean(ref[True]) / max(ref[True]))
    # CPU slots: no times, so no projection
    for k in ("single_device_frame_ms", "plan_chunk_frame_ms", "shard_ms",
              "slowest_shard_ms", "projected_mesh_frame_ms",
              "compute_fraction", "projected_efficiency"):
        assert rec[k] is None, k
    assert rec["collective_bytes_per_frame"]["total"] == 8 * per * chunk * 12


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_frame_all_reduce_bytes_are_the_bytes_reduced(monkeypatch):
    """Under a one-rank gloo group the sharded render hands its framebuffer
    to dist.all_reduce once; those bytes are the proxy's computed
    figure."""
    cfg = TConfig(width=32, height=16, spp=2, max_depth=2, accel="brute",
                  ray_chunk=64, scene="test")
    scene, cam = get_world("test", device="cpu")
    reduced = []
    all_reduce = torch.distributed.all_reduce

    def recording(tensor, *args, **kw):
        reduced.append(tensor.numel() * tensor.element_size())
        return all_reduce(tensor, *args, **kw)
    monkeypatch.setattr(torch.distributed, "all_reduce", recording)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0)
    try:
        mesh = make_mesh(["cpu"] * 4, spp_axis_size=2)
        img = make_sharded_renderer(cfg, mesh)(scene, cam)
    finally:
        torch.distributed.destroy_process_group()
    assert bool(torch.isfinite(img).all())
    assert reduced == [sharded.frame_all_reduce_bytes(cfg, mesh)]
    assert reduced[0] > 0
