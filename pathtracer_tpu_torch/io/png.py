"""PNG output and input.

Quantization: clamp to [0, 0.999], multiply by 256, truncate to a byte.
Row 0 of the renderer's framebuffer is the bottom scanline, so rows are
flipped on write. :func:`write_png` encodes through the port's native
library (``native/src/ptnative.cpp``: filter byte 0 on every row, zlib level
6, one IDAT chunk); :func:`encode_png` is its plain twin, byte for byte, for
the tests. The reader takes 8-bit, non-interlaced images (texture files).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from pathtracer_tpu_torch.native import bindings


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
    """RGBA8 (H, W, 4) -> PNG bytes: the plain twin of the native
    encoder."""
    h, w = rgba.shape[:2]
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img, flip_rows: bool = True) -> None:
    """Write an f32 [0,1] (H, W, 3) image (numpy array or CPU tensor)
    through the native encoder."""
    img = np.asarray(img)
    if flip_rows:
        img = img[::-1]
    bindings.write_png(path, quantize(img))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced PNG -> f32 (H, W, C) in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB",
                                                        payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bit_depth != 8:
        raise ValueError(f"{path}: only 8-bit PNGs are supported")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                             np.uint8).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        else:
            # sub / average / paeth depend on the bytes to their left
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = prev[x]
                c = prev[x - channels] if x >= channels else 0
                if ftype == 1:
                    cur[x] = (line[x] + a) & 0xFF
                elif ftype == 3:
                    cur[x] = (line[x] + (a + b) // 2) & 0xFF
                elif ftype == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pr = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                    cur[x] = (line[x] + pr) & 0xFF
                else:
                    raise ValueError(f"{path}: bad PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, channels).astype(np.float32) / 255.0
