"""Wavefront OBJ ingestion.

:func:`load_obj` parses through the port's native library
(``native/src/ptnative.cpp``), which reads the records as the reference's
native parser does (``pathtracer_tpu/native/src/ptnative.cpp``) but takes
every line whole. :func:`load_obj_python` is its plain twin: the same
records, read byte by byte in Python and numpy, for the tests.

A record is a line (split at ``\\n`` only) whose first byte is ``v`` or
``f`` and whose second is a space or a tab:

- ``v``: three numbers as glibc's ``sscanf("%lf %lf %lf")`` reads them
  (decimal, hex, ``inf``/``infinity``, ``nan``), each rounded from double
  to float32; a record with fewer than three is skipped;
- ``f``: tokens split by spaces and tabs, each read as far as its leading
  ``strtol`` integer (the rest, such as ``/vt/vn``, skipped); the first
  token without one ends the record. An index i > 0 is vertex i - 1, any
  other is ``nverts + i`` (``nverts``: the vertices read so far). Polygons
  are fan-triangulated around their first vertex.

C sees a line only up to its first NUL byte, and so does the twin.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from pathtracer_tpu_torch.native import bindings

# C's isspace in the "C" locale
_SPACE = frozenset(b" \t\n\v\f\r")
_DIGITS = frozenset(b"0123456789")
_XDIGITS = frozenset(b"0123456789abcdefABCDEF")
_LONG_MIN, _LONG_MAX = -2 ** 63, 2 ** 63 - 1


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file through the native library -> (vertices (V, 3)
    float32, faces (F, 3) int32)."""
    return bindings.load_obj(path)


def _lower(c: int) -> int:
    return c | 0x20 if 0x41 <= c <= 0x5A else c


def _strtod_prefix(buf: bytes) -> Tuple[float, int]:
    """glibc ``strtod`` on a buffer that ``_scan_double`` collected:
    (value, bytes consumed), 0 consumed when no number starts it."""
    neg = buf[:1] == b"-"
    i = 1 if buf[:1] in (b"+", b"-") else 0
    word = buf[i:].lower()
    if word.startswith(b"nan"):
        return math.copysign(math.nan, -1.0 if neg else 1.0), i + 3
    if word.startswith(b"inf"):
        n = 8 if word.startswith(b"infinity") else 3
        return -math.inf if neg else math.inf, i + n
    hexa = word.startswith(b"0x")
    digits = _XDIGITS if hexa else _DIGITS
    j = start = i + 2 if hexa else i
    while j < len(buf) and (buf[j] in digits or buf[j] == 0x2E):
        j += 1      # the scanner let at most one "." through
    if not buf[start:j].replace(b".", b""):
        # no digit: "0x" alone reads as the number 0, "." as nothing
        return (-0.0 if neg else 0.0, i + 1) if hexa else (0.0, 0)
    if j < len(buf) and _lower(buf[j]) == (0x70 if hexa else 0x65):
        k = j + 1   # an exponent counts only with a digit
        if k < len(buf) and buf[k] in b"+-":
            k += 1
        if k < len(buf) and buf[k] in _DIGITS:
            while k < len(buf) and buf[k] in _DIGITS:
                k += 1
            j = k
    text = buf[:j].decode("ascii")
    if not hexa:
        return float(text), j
    try:
        return float.fromhex(text), j
    except OverflowError:
        return -math.inf if neg else math.inf, j


def _scan_double(s: bytes, i: int) -> Tuple[Optional[float], int]:
    """One ``%lf`` conversion of glibc's ``sscanf`` at ``s[i:]``: (value,
    position after the bytes it took), or (None, _) on a failed
    conversion. scanf collects the bytes of a number's grammar first and
    then converts the longest ``strtod`` prefix of them: bytes collected
    past that prefix are consumed all the same."""
    n = len(s)
    while i < n and s[i] in _SPACE:
        i += 1
    if i >= n:
        return None, i
    start = i
    got_sign = s[i] in b"+-"
    if got_sign:
        i += 1
        if i >= n:
            return None, i
    c = _lower(s[i])
    if c in b"ni":
        word = b"nan" if c == 0x6E else b"inf"
        if s[i:i + 3].lower() != word:
            return None, i
        i += 3
        if c == 0x69 and i < n and _lower(s[i]) == 0x69:  # "infinity"
            if s[i:i + 5].lower() != b"inity":
                return None, i
            i += 5
        return _strtod_prefix(s[start:i])[0], i
    hexa = got_digit = got_dot = got_e = False
    exp_char = 0x65  # "e"
    if c == 0x30:  # "0"
        i += 1
        if i < n and _lower(s[i]) == 0x78:  # "x"
            i += 1
            hexa, exp_char = True, 0x70  # "p"
        else:
            got_digit = True
    while i < n:
        c = s[i]
        if c in _DIGITS or (hexa and not got_e and c in _XDIGITS):
            got_digit = True
        elif got_e and _lower(s[i - 1]) == exp_char and c in b"+-":
            pass
        elif got_digit and not got_e and _lower(c) == exp_char:
            got_e = got_dot = True
        elif not got_dot and c == 0x2E:  # "."
            got_dot = True
        else:
            break
        i += 1
    size = i - start
    if size == got_sign or (hexa and size == 2 + got_sign):
        return None, i
    value, used = _strtod_prefix(s[start:i])
    return (value if used else None), i


def _scan_long(s: bytes, i: int) -> Tuple[Optional[int], int]:
    """``strtol(s + i, &end, 10)``: (value clamped to a C long, end), or
    (None, i) where no integer starts."""
    n = len(s)
    j = i
    while j < n and s[j] in _SPACE:
        j += 1
    neg = j < n and s[j] == 0x2D
    if j < n and s[j] in b"+-":
        j += 1
    k = j
    while k < n and s[k] in _DIGITS:
        k += 1
    if k == j:
        return None, i
    digits = s[j:k].lstrip(b"0")    # past 19 digits it saturates
    v = int(digits[:20] or b"0")
    v = -v if neg else v
    return min(max(v, _LONG_MIN), _LONG_MAX), k


def _int32(v: int) -> int:
    """C's (int32_t) conversion of a long: the low 32 bits, signed."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def load_obj_python(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The plain twin of :func:`load_obj`: the same records, parsed in
    Python -> (vertices (V, 3) float32, faces (F, 3) int32)."""
    with open(path, "rb") as f:
        data = f.read()
    verts: List[float] = []   # x, y, z doubles
    faces: List[int] = []
    for line in data.split(b"\n"):
        line = line.split(b"\0", 1)[0] + b"\n"
        if line[1:2] not in (b" ", b"\t"):
            continue
        if line[0] == 0x76:  # "v"
            xyz, i = [], 2
            for _ in range(3):
                value, i = _scan_double(line, i)
                if value is None:
                    break
                xyz.append(value)
            if len(xyz) == 3:
                verts.extend(xyz)
        elif line[0] == 0x66:  # "f"
            nverts = len(verts) // 3
            idx, i = [], 2
            while i < len(line):
                while line[i] in b" \t":
                    i += 1
                if line[i] in b"\n\r":
                    break
                value, i = _scan_long(line, i)
                if value is None:
                    break
                while line[i] not in b" \t\n\r":
                    i += 1
                idx.append(_int32(value - 1 if value > 0 else nverts + value))
            for k in range(1, len(idx) - 1):
                faces += (idx[0], idx[k], idx[k + 1])
    with np.errstate(over="ignore"):  # C's (float) cast: inf, silently
        v32 = np.asarray(verts, np.float64).astype(np.float32)
    return v32.reshape(-1, 3), np.asarray(faces, np.int32).reshape(-1, 3)
