"""Closed loop of progressive renders: images of the configuration rendered
back to back through ``Renderer.render_passes``, each in passes of the
mix's ``spp_per_pass`` samples, the renderer built with its stats on, as
the CLI builds it. Image ``i`` of a run at seed ``n`` renders at seed
``n * MAX_IMAGES + i``; the scene is the configuration's own.

Each pass ends in the ``on_pass`` hook with a synchronise and a host
timestamp. The window counts the samples of the passes that ended inside
it, over the time from its start to the end of its last whole pass; the
pass that ends after it is left out, and the run stops there.

Set-up builds the scene, the renderer and its closest-hit tables, then
renders one sample of the first chunk of image 0 through the renderer's
``render_sum`` as the warm-up: every chunk of every pass has that shape
and runs the same kernels, and nothing is compiled per call. The traced run renders one
image of the mix's ``trace_passes`` passes under the profiler, with a
renderer of that many samples an image (the passes are the same work),
each closest-hit query under the harness's span
(``perfbench.trace.span_queries``).

Answers: for each image the window touched, its framebuffer after its
last whole pass in the window, the samples in it, the finished image
where it finished, and the spp its renderer was built for (the traced
run's differs from the configuration's, and stratified jitter follows
it).
"""
from __future__ import annotations

import time
from types import SimpleNamespace

MAX_IMAGES = 1024


class _WindowClosed(Exception):
    pass


def _render_config(config: dict, spp: int):
    from pathtracer_tpu_torch.config import RenderConfig
    return RenderConfig(width=config["width"], height=config["height"],
                        spp=spp, max_depth=config["max_depth"],
                        t_min=config["t_min"], sky=config["sky"],
                        nee=config["nee"],
                        stratify=config.get("stratify", False),
                        accel=config["accel"],
                        ray_chunk=config["ray_chunk"], scene=config["scene"])


def image_seed(seed: int, i: int) -> int:
    if i >= MAX_IMAGES:
        raise RuntimeError(f"more than {MAX_IMAGES} images in one run")
    return seed * MAX_IMAGES + i


def setup(config: dict, traffic: dict, seed: int, device: str, traced: bool):
    from pathtracer_tpu_torch.render.renderer import make_renderer
    from pathtracer_tpu_torch.scene.worlds import get_world

    pp = traffic["spp_per_pass"]
    spp = traffic["trace_passes"] * pp if traced else config["spp"]
    t = time.perf_counter()
    scene, cam = get_world(config["scene"], device=device,
                           **config.get("scene_args", {}))
    renderer = make_renderer(_render_config(config, spp), device,
                             with_stats=True)
    renderer.prepare(scene)
    _sync(device)
    tables_s = time.perf_counter() - t
    if traced:
        from perfbench.trace import span_queries
        span_queries(renderer, scene)
    state = SimpleNamespace(seed=seed, device=device, scene=scene, cam=cam,
                            renderer=renderer, pp=pp, spp=renderer.cfg.spp,
                            pixels=config["width"] * config["height"])
    t = time.perf_counter()
    _warm_up(renderer, scene, cam, image_seed(seed, 0), device)
    state.setup_phases = {"scene and tables": tables_s,
                          "warm-up": time.perf_counter() - t}
    return state


def _warm_up(renderer, scene, cam, seed: int, device):
    """One sample of the first chunk of the image, as a pass renders it."""
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.render.renderer import (padded_pixel_grid,
                                                      render_sum)
    cfg = renderer.cfg
    chunk = min(cfg.ray_chunk, cfg.num_pixels)
    rows, cols = padded_pixel_grid(cfg, chunk, device)
    render_sum(scene, cam.to(device), prng.PRNGKey(seed), rows[:chunk],
               cols[:chunk], cfg, 1, renderer.prepare(scene))
    _sync(device)


def _sync(device):
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def measure(state, seconds: float, capture=None):
    """Run the window; returns a namespace of ``samples`` (pixel samples),
    ``seconds``,
    ``passes``, ``answers`` and ``stats`` (the renderer's executed
    (queries, shadow queries, pair tests) of the finished images)."""
    if capture is not None:
        return _measure_traced(state, capture)
    answers = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    clock = SimpleNamespace(last=t_start, samples=0, passes=0, pass_s=[])
    stats = [0.0, 0.0, 0.0]
    for i in range(MAX_IMAGES):
        answer = SimpleNamespace(seed=image_seed(state.seed, i), samples=0,
                                 framebuffer=None, image=None,
                                 spp=state.spp)

        def on_pass(acc, done, answer=answer):
            _sync(state.device)
            now = time.perf_counter()
            if now > deadline:
                raise _WindowClosed
            clock.samples += (done - answer.samples) * state.pixels
            clock.passes += 1
            clock.pass_s.append(now - clock.last)
            clock.last = now
            answer.samples, answer.framebuffer = done, acc
        try:
            image, img_stats = state.renderer.render_passes(
                state.scene, state.cam, state.pp, seed=answer.seed,
                on_pass=on_pass)
        except _WindowClosed:
            if answer.samples:
                answers.append(answer)
            break
        answer.image = image
        stats = [a + b for a, b in zip(stats, img_stats)]
        answers.append(answer)
    return SimpleNamespace(samples=clock.samples,
                           seconds=clock.last - t_start,
                           passes=clock.passes, pass_s=clock.pass_s,
                           answers=answers, stats=stats)


def _measure_traced(state, capture):
    answer = SimpleNamespace(seed=image_seed(state.seed, 0), samples=0,
                             framebuffer=None, image=None, spp=state.spp)
    passes = [0]

    def on_pass(acc, done):
        capture.sync()
        passes[0] += 1
        answer.samples, answer.framebuffer = done, acc
    t0 = time.perf_counter()
    capture.start()
    image, stats = state.renderer.render_passes(
        state.scene, state.cam, state.pp, seed=answer.seed, on_pass=on_pass)
    capture.stop()
    answer.image = image
    seconds = time.perf_counter() - t0
    return SimpleNamespace(samples=answer.samples * state.pixels,
                           seconds=seconds, passes=passes[0],
                           pass_s=[seconds], answers=[answer],
                           stats=list(stats))
