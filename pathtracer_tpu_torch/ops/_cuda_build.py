"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled with nvcc
into its own shared library under ``pathtracer_tpu_torch/_build/`` at first
use, then loaded with ctypes. The library name carries a hash of the source,
of every shared ``csrc/*.cuh`` header and of the flags, so an edited source
or header rebuilds and a built one is reused. :func:`build_all` compiles
several sources at once, one nvcc process each. Nothing here runs at import
time: the CPU-only test environment has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# sm_90a (Hopper). --fmad=false keeps every product and sum separately
# rounded, as in the plain PyTorch twins, so kernel and twin agree to the
# bit; no fast math, so division and sqrt stay IEEE.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_LIBS: dict = {}       # source name -> loaded ctypes.CDLL
_TYPED: set = set()    # source names whose prototypes are set
BUILD_LOGS: dict = {}  # source name -> nvcc output of the build (if built)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)"
                           "; the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` at its current source,
    headers and flags lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all(names) -> dict:
    """Compile each ``csrc/<name>.cu`` that has no up-to-date library, all
    nvcc processes at once; returns {name: library path}. Raises if any
    build fails, after every process has ended."""
    paths = {name: library_path(name) for name in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            src = os.path.join(CSRC, name + ".cu")
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, tmp, proc))
        failed = []
        for name, tmp, proc in jobs:
            BUILD_LOGS[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n"
                              f"{BUILD_LOGS[name]}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path."""
    return build_all([name])[name]


def load(name: str, prototypes: dict = None) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.
    ``prototypes`` ({function: argtypes}, each returning a C int) are set
    on the library's functions once, the first time they are given."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _LIBS[name] = lib
    if prototypes and name not in _TYPED:
        for fn_name, argtypes in prototypes.items():
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _TYPED.add(name)
    return lib


def ptxas_summary(log: str) -> list:
    """(function, registers, spill store bytes, spill load bytes) of each
    kernel in an nvcc ``-Xptxas -v`` log."""
    out, func, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            func = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and func is not None:
            out.append((func, int(m.group(1)), *spills))
            func, spills = None, (0, 0)
    return out


def check_arg(x, name: str, dtype, shape, device) -> None:
    """Raise unless tensor ``x`` has ``dtype``, ``shape``, is contiguous,
    lies on ``device`` and carries no autograd history (a kernel has no
    backward): what a kernel wrapper checks before it passes a pointer."""
    if x.requires_grad:
        raise ValueError(f"{name} requires grad; pass it detached")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
