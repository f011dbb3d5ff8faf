"""ctypes bindings to the port's native host library (``src/ptnative.cpp``).

The library is built with g++ at first use (``native/build.py``) and is
required: every mesh load (``io/obj.load_obj``) and image write
(``io/png.write_png``) goes through it. A missing g++, a failed build or a
nonzero return code raises; nothing falls back to the Python twins, which
the tests hold the library against.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import numpy as np

from pathtracer_tpu_torch.native import build

# The reference's name for the library's path; a function here, since the
# path carries the source's hash.
LIB_PATH = build.library_path

_FLOATS = ctypes.POINTER(ctypes.c_float)
_INTS = ctypes.POINTER(ctypes.c_int32)
_BYTES = ctypes.POINTER(ctypes.c_ubyte)
_LONG_P = ctypes.POINTER(ctypes.c_long)
_PROTOTYPES = {
    "pt_obj_counts": [ctypes.c_char_p, _LONG_P, _LONG_P],
    "pt_obj_load": [ctypes.c_char_p, _FLOATS, ctypes.c_long, _INTS,
                    ctypes.c_long],
    "pt_write_png": [ctypes.c_char_p, _BYTES, ctypes.c_int, ctypes.c_int],
}


@functools.cache
def _load() -> ctypes.CDLL:
    """Build (if needed) and load the library, its prototypes set once;
    cached per process."""
    lib = ctypes.CDLL(build.build(), use_errno=True)
    for name, argtypes in _PROTOTYPES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    """The reference's check before its native path. The port has no other
    path: this builds and loads the library and returns True, or raises as
    :func:`build.build` does."""
    _load()
    return True


def _call(fn: str, path: str, *args) -> None:
    """``fn(path, *args)``; raises OSError with its return code unless it
    returns 0 (with errno for code 1, a failed open, read or write)."""
    ctypes.set_errno(0)
    rc = getattr(_load(), fn)(os.fsencode(path), *args)
    if rc != 0:
        err = ctypes.get_errno() if rc == 1 else 0
        why = f": {os.strerror(err)}" if err else ""
        raise OSError(err, f"{fn} returned {rc}{why}", path)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (vertices (V, 3) float32, faces (F, 3) int32)."""
    nv, nf = ctypes.c_long(), ctypes.c_long()
    _call("pt_obj_counts", path, ctypes.byref(nv), ctypes.byref(nf))
    verts = np.zeros((nv.value, 3), np.float32)
    faces = np.zeros((nf.value, 3), np.int32)
    _call("pt_obj_load", path, verts.ctypes.data_as(_FLOATS), nv.value,
          faces.ctypes.data_as(_INTS), nf.value)
    return verts, faces


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write an RGBA8 (H, W, 4) image, top row first, as a PNG file."""
    rgba = np.ascontiguousarray(rgba)
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected an (H, W, 4) uint8 RGBA image, got "
                         f"{rgba.dtype} {rgba.shape}")
    h, w = rgba.shape[:2]
    _call("pt_write_png", path, rgba.ctypes.data_as(_BYTES), w, h)
