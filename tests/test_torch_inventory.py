"""The port's inventory: everything public in ``pathtracer_tpu`` has its
counterpart in ``pathtracer_tpu_torch``.

Both packages are read with ``ast``; neither is imported. For each public
module-level function and class and each UPPER_CASE constant of the JAX
package, and for its three Pallas kernel functions, one of these holds:

- the port's counterpart module (the same path under
  ``pathtracer_tpu_torch/``) binds the same name;
- ``RENAMED`` gives the port's name for it, and that name exists;
- ``NOT_PORTED`` quotes the bullet of ROADMAP.md's "Not ported" list that it
  falls under, and the quote is in that list.

An entry of either map whose JAX name no longer exists fails, so the maps
cannot outlive what they excuse.
"""
import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "pathtracer_tpu")
PORT = os.path.join(ROOT, "pathtracer_tpu_torch")
UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")

# the three functions that reach pl.pallas_call (PERF.md's kernel table)
PALLAS_KERNELS = ("ops/cluster_sweep.py::_march_kernel",
                  "ops/cluster_sweep.py::_window_kernel",
                  "ops/pallas_sweep.py::_sweep_kernel")

# JAX "module::name" -> the port's "path::name" (a path under
# pathtracer_tpu_torch/; a Python module binds the name, "Class.method"
# included, and any other source holds the identifier)
RENAMED = {
    "ops/cluster_sweep.py::_march_kernel":
        "csrc/cluster_march.cu::cluster_march_kernel",
    "ops/cluster_sweep.py::_window_kernel":
        "csrc/window_sweep.cu::window_sweep_kernel",
    "ops/pallas_sweep.py::_sweep_kernel":
        "csrc/dense_sweep.cu::dense_sweep_kernel",
    # the rays one block of the dense sweep holds: kLanes x kRT
    "ops/pallas_sweep.py::DEF_RAY_TILE": "csrc/dense_sweep.cu::kLanes",
    "oracle.py::compare_to_jax": "oracle.py::compare_to_torch",
    # Russian roulette's constants live with the shading step it is part of
    "render/integrator.py::K_RR_CONTINUE": "ops/shade.py::K_RR_CONTINUE",
    "render/integrator.py::K_RR_INV_CONTINUE":
        "ops/shade.py::K_RR_INV_CONTINUE",
    "oracle.py::render_jax_linear": "oracle.py::render_torch_linear",
    # the tables are built once per scene by the renderer's query
    "render/renderer.py::prepare_cluster_tables":
        "render/renderer.py::Renderer.prepare",
    "utils/checkpoint.py::save_fit_state_orbax":
        "utils/checkpoint.py::save_fit_state_torch",
    "utils/checkpoint.py::load_fit_state_orbax":
        "utils/checkpoint.py::load_fit_state_torch",
}

_GATHER = "the `ops/gather.py` take-vs-matmul policy"
_PRECISION = "the fused6 / bf16x3 / high precision modes"
_ABSENT = "waiting for files that are not in the repository"

# JAX "module::name" -> a quote of its ROADMAP "Not ported" bullet
NOT_PORTED = {
    "ops/gather.py::MATMUL_MAX_ROWS": _GATHER,
    "ops/gather.py::exact_rows": _GATHER,
    "ops/tensor_sweep.py::expand6_lhs": _PRECISION,
    "ops/tensor_sweep.py::expand6_rhs": _PRECISION,
    "ops/tensor_sweep.py::fused6_dot": _PRECISION,
    "ops/tensor_sweep.py::split3_bf16": _PRECISION,
    "ops/tensor_sweep.py::sweep_dot": _PRECISION,
    "ops/tensor_sweep.py::sweep_mode": _PRECISION,
    "scene/bunny.py::REFERENCE_OBJ": _ABSENT,
    "scene/cornell.py::CORNELL_DIR": _ABSENT,
    "utils/metrics.py::PhaseTimer":
        "`utils/metrics.PhaseTimer`: an unsynchronised phase timer; the "
        "port's spans replace it",
}

# slices that must be ported under their own names
SAME_NAME = ("native/", "core/rays.py::Rays",
             "core/sampling.py::uniform_on_hemisphere", "core/vec.py::lerp",
             "core/vec.py::INFINITY")


def _tree(path):
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), path)


def _statements(body):
    """Module-level statements, through if/try blocks."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            for block in (node.body, node.orelse,
                          getattr(node, "finalbody", []),
                          *[h.body for h in getattr(node, "handlers", [])]):
                yield from _statements(block)
        else:
            yield node


def _bound(path):
    """Every name a module binds at module level, with "Class.method" for
    each method."""
    names = set()
    for node in _statements(_tree(path).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def _public(path):
    """The public functions and classes and UPPER_CASE constants a module
    defines."""
    out = set()
    for node in _statements(_tree(path).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if not node.name.startswith("_"):
                out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update(n.id for t in targets for n in ast.walk(t)
                       if isinstance(n, ast.Name) and UPPER.match(n.id))
    return out


def _modules(pkg):
    for root, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), pkg)


def _inventory():
    """{JAX module: the names of it the port must answer for}."""
    out = {m: sorted(_public(os.path.join(JAX, m))) for m in _modules(JAX)}
    for key in PALLAS_KERNELS:
        module, name = key.split("::")
        out[module].append(name)
    return {m: names for m, names in out.items() if names}


def _port_has(target):
    path, name = target.split("::")
    full = os.path.join(PORT, path)
    if not os.path.exists(full):
        return False
    if path.endswith(".py"):
        return name in _bound(full)
    with open(full, encoding="utf-8") as f:
        return re.search(rf"\b{re.escape(name)}\b", f.read()) is not None


def _not_ported_list():
    """ROADMAP.md's "Not ported" list, whitespace collapsed."""
    with open(os.path.join(ROOT, "ROADMAP.md"), encoding="utf-8") as f:
        text = f.read()
    start = text.index("**Not ported.**")
    end = text.index("\n### ", start)
    return " ".join(text[start:end].split())


@pytest.mark.parametrize("module", list(_inventory()))
def test_jax_module_has_its_counterparts(module):
    """Each name of one JAX module: the same name in the port's module, a
    rename that exists, or a quote of ROADMAP's Not ported list."""
    not_ported = _not_ported_list()
    missing = []
    for name in _inventory()[module]:
        key = f"{module}::{name}"
        if key in RENAMED:
            ok = _port_has(RENAMED[key])
        elif key in NOT_PORTED:
            ok = NOT_PORTED[key] in not_ported
        else:
            ok = _port_has(key)
        if not ok:
            missing.append(RENAMED.get(key) or NOT_PORTED.get(key) or key)
    assert not missing, f"pathtracer_tpu/{module}: no counterpart for " \
        f"{missing}"


def test_maps_name_only_what_exists():
    """Each map entry and Pallas kernel names a JAX name that exists, and
    no slice that must keep its names is excused."""
    inventory = {f"{m}::{n}" for m, names in _inventory().items()
                 for n in names}
    for key in PALLAS_KERNELS:
        module, name = key.split("::")
        assert name in _bound(os.path.join(JAX, module)), key
    for key in list(RENAMED) + list(NOT_PORTED):
        assert key in inventory, f"{key} is no longer in pathtracer_tpu"
        assert not key.startswith(SAME_NAME), \
            f"{key} must be ported under its own name"
    assert not set(RENAMED) & set(NOT_PORTED)
