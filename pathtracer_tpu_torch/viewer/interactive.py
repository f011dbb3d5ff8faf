"""Interactive progressive viewer (``viewer/interactive.py``).

Renders on the device, gathers the framebuffer to the host and presents it
in the terminal as ANSI half-block cells. WASD/QE moves the camera, ESC or
x quits; the title line shows the size, the frame rate and the passes.
Samples accumulate across frames while the camera is still and restart on
a move.

:class:`ViewerSession` holds the accumulation and the camera (testable
without a terminal); :func:`run_viewer` adds raw-mode input and the ANSI
output.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.core.camera import Camera, Direction, move_camera
from pathtracer_tpu_torch.render.renderer import Renderer

_KEYMAP = {
    "w": Direction.FORWARD, "s": Direction.BACKWARD,
    "a": Direction.LEFT, "d": Direction.RIGHT,
    "q": Direction.UP, "e": Direction.DOWN,
}


class ViewerSession:
    """Progressive accumulation and the camera's state. Each frame renders
    ``spp_per_frame`` samples on ``device`` through one
    :class:`~pathtracer_tpu_torch.render.renderer.Renderer`, so the
    scene's route (the LBVH on the "bvh" route) is built once."""

    def __init__(self, scene, cam: Camera, cfg: RenderConfig,
                 spp_per_frame: int = 2, device="cuda"):
        self.scene = scene
        self.cam = cam
        self.base_cfg = cfg
        self.frame_cfg = cfg.replace(spp=spp_per_frame)
        self._render = Renderer(self.frame_cfg, device)
        self._acc: Optional[np.ndarray] = None  # linear-light sum of passes
        self._passes = 0

    def handle_key(self, key: str, delta_time: float) -> bool:
        """Apply a key; True if the camera moved (accumulation restarts)."""
        d = _KEYMAP.get(key.lower())
        if d is None:
            return False
        self.cam = move_camera(self.cam, d, delta_time)
        self._acc = None
        self._passes = 0
        return True

    def step(self) -> np.ndarray:
        """Render one pass, fold it into the accumulator and return the
        current gamma-2 image (H, W, 3) f32, row 0 at the bottom: the
        passes are averaged in linear light (each frame squared)."""
        img = self._render(self.scene, self.cam,
                           self.base_cfg.seed + self._passes).cpu().numpy()
        linear = img.astype(np.float64) ** 2
        if self._acc is None:
            self._acc = linear
        else:
            self._acc += linear
        self._passes += 1
        return np.sqrt(self._acc / self._passes).astype(np.float32)

    @property
    def passes(self) -> int:
        return self._passes


# Fixed-width cell template: zero-padded color components keep every cell
# exactly 41 bytes, so the whole frame assembles as ONE preallocated uint8
# buffer with vectorized digit stores (a per-pixel Python f-string loop is
# pathological beyond preview sizes; np.char.add is no faster). ANSI
# accepts leading zeros in SGR parameters.
_CELL = np.frombuffer(
    "\x1b[38;2;000;000;000m\x1b[48;2;000;000;000m▀".encode(), np.uint8)
_EOL = np.frombuffer(b"\x1b[0m\n", np.uint8)
_DIGIT_POS = (7, 11, 15, 26, 30, 34)  # tR tG tB bR bG bB start offsets


def _ansi_frame(img: np.ndarray) -> str:
    """Render (H, W, 3) f32 row-0-bottom to ANSI half-block text."""
    h, w = img.shape[:2]
    rgb = (np.clip(img[::-1], 0.0, 0.999) * 256).astype(np.uint8)
    if h % 2:
        rgb = rgb[:-1]
    h2 = rgb.shape[0] // 2
    buf = np.empty((h2, w * len(_CELL) + len(_EOL)), np.uint8)
    cells = buf[:, :w * len(_CELL)].reshape(h2, w, len(_CELL))
    cells[:] = _CELL
    buf[:, w * len(_CELL):] = _EOL
    comps = np.concatenate([rgb[0::2], rgb[1::2]], axis=2)  # (h2, w, 6)
    for i, pos in enumerate(_DIGIT_POS):
        v = comps[..., i].astype(np.uint16)
        cells[..., pos] = v // 100 + 48
        cells[..., pos + 1] = v // 10 % 10 + 48
        cells[..., pos + 2] = v % 10 + 48
    return buf.tobytes()[:-1].decode()  # drop the trailing newline


def run_viewer(scene, cam: Camera, cfg: RenderConfig,
               max_frames: Optional[int] = None, device="cuda") -> int:
    """Terminal loop on ``device``. Needs a TTY for input; without one it
    renders ``max_frames`` (default 8) passes and returns. Keys are read a
    byte at a time from the file descriptor, so a key that arrives with
    another is not left in a buffer that ``select`` cannot see."""
    import select
    import termios
    import tty

    sess = ViewerSession(scene, cam, cfg, device=device)
    is_tty = sys.stdin.isatty()
    fd = sys.stdin.fileno() if is_tty else None
    frames = 0
    last = time.perf_counter()
    fps = 0.0
    old_attrs = None
    if is_tty:
        old_attrs = termios.tcgetattr(fd)
        tty.setcbreak(fd)
    try:
        sys.stdout.write("\x1b[2J")  # clear
        while True:
            img = sess.step()
            now = time.perf_counter()
            dt = now - last
            fps = 0.9 * fps + 0.1 * (1.0 / max(dt, 1e-6))
            last = now
            sys.stdout.write("\x1b[H")
            sys.stdout.write(
                f"({cfg.width} x {cfg.height}) - FPS: {fps:.2f} - "
                f"passes: {sess.passes}  [wasd/qe move, x quit]\n")
            sys.stdout.write(_ansi_frame(img) + "\n")
            sys.stdout.flush()
            frames += 1
            if max_frames is not None and frames >= max_frames:
                return 0
            if not is_tty and frames >= 8:
                return 0
            if is_tty:
                r, _, _ = select.select([fd], [], [], 0.0)
                if r:
                    key = os.read(fd, 1).decode(errors="replace")
                    if key in ("x", "\x1b", ""):
                        return 0
                    sess.handle_key(key, dt)
    finally:
        if old_attrs is not None:
            termios.tcsetattr(fd, termios.TCSADRAIN, old_attrs)
