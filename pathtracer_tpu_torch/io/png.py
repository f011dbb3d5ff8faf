"""Minimal RGBA8 PNG writer (numpy copy of ``io/png.py``).

Quantization: clamp to [0, 0.999], multiply by 256, truncate to a byte.
Row 0 of the renderer's framebuffer is the bottom scanline, so rows are
flipped on write.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def quantize(img: np.ndarray) -> np.ndarray:
    """f32 [0,1] (H, W, 3) -> RGBA8 (alpha 255)."""
    img = np.asarray(img, np.float32)
    rgb = (np.clip(img, 0.0, 0.999) * 256.0).astype(np.uint8)
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray) -> bytes:
    """RGBA8 (H, W, 4) -> PNG bytes."""
    h, w = rgba.shape[:2]
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img, flip_rows: bool = True) -> None:
    """Write an f32 [0,1] (H, W, 3) image (numpy array or CPU tensor)."""
    img = np.asarray(img)
    if flip_rows:
        img = img[::-1]
    with open(path, "wb") as f:
        f.write(encode_png(quantize(img)))
