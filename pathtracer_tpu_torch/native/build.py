"""Build the port's native host library (``src/ptnative.cpp``) with g++.

The library goes to ``pathtracer_tpu_torch/_build/`` under a name that
carries a hash of the source and the flags, so an edited source rebuilds and
a built one is reused. It is written to a temporary file and renamed into
place, so several processes may build it at once. Nothing here runs at
import time.

    python -m pathtracer_tpu_torch.native.build   # prints the library's path
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src", "ptnative.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

# No -march=native: a library built for one host's CPU must not be loaded
# on another, and it changes no result here.
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lz"]


def library_path() -> str:
    """Where the library of the current source and flags lives (built or
    not)."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libptnative_{digest.hexdigest()[:16]}.so")


# The reference's name for the built library's path; a function here, since
# the path carries the source's hash.
OUT = library_path


def build() -> str:
    """Compile the library unless an up-to-date one exists; returns its
    path. Raises RuntimeError, with the compiler's output, when g++ is
    missing or fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native host "
                           "library (OBJ parser, PNG encoder) cannot be "
                           "built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, SRC, "-o", tmp, *LIBS],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SRC}:\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


if __name__ == "__main__":
    print(build())
