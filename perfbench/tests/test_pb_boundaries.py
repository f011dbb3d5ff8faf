"""What the harness may load, and how it fails: no module under
``perfbench/`` imports JAX, the JAX package or the program's own bench;
the reference imports nothing of the program and reads no environment
variable; a run with no card, or in a checkout without the program, fails
with its cause and prints no result."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.run import ROOT

PB = os.path.join(ROOT, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "pathtracer_tpu"}


def imports(path):
    """The dotted names ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names += [node.module] + [f"{node.module}.{a.name}"
                                      for a in node.names]
    return names


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        for name in imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            assert not name.startswith("pathtracer_tpu_torch.bench"), (
                path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        for name in imports(path):
            assert name.split(".")[0] != "pathtracer_tpu_torch", (path, name)


def test_the_reference_reads_no_environment_variable():
    for path in sources("reference"):
        with open(path) as f:
            text = f.read()
        assert "environ" not in text and "getenv" not in text, path


def run_harness(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "bunny-128spp",
         "--seed", "2147483713", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_a_run_with_no_card_fails_with_its_cause():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_harness(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_harness(tmp_path, env={"PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
