"""The port's native host library (``pathtracer_tpu_torch/native``): the
PNG encoder against the reference's and the plain twin, byte for byte; the
build (hashed name, atomic under concurrent builds, errors carry the
compiler's output, no quiet fallback); every mesh load and image write
of the port's entry points going through it; and the root ``conftest.py``
hook that builds the reference's library before the test workers start.

The OBJ parser's parity with the reference is ``tests/test_torch_obj.py``.
"""
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from pathtracer_tpu.io import png as jpng
from pathtracer_tpu.native import bindings as jbindings
from pathtracer_tpu.native import build as jbuild
from pathtracer_tpu_torch import __main__ as tcli
from pathtracer_tpu_torch import presets as tpresets
from pathtracer_tpu_torch.io import obj as tobj
from pathtracer_tpu_torch.io import png as tpng
from pathtracer_tpu_torch.native import bindings, build
from pathtracer_tpu_torch.scene import bunny as tbunny
from pathtracer_tpu_torch.scene import cornell as tcornell
from pathtracer_tpu_torch.scene.standalone_assets import cornell_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (90, 160)])
def test_write_png_matches_reference_and_twin(shape, tmp_path):
    """The port's ``write_png`` (native) writes the bytes of the reference's
    ``write_png`` and of the twin ``encode_png``, and reads back."""
    img = np.random.default_rng(sum(shape)).random(shape + (3,),
                                                   dtype=np.float32)
    img[0, 0] = (-1.0, 0.5, 2.0)   # clamped on both ends
    ours, ref = tmp_path / "port.png", tmp_path / "ref.png"
    tpng.write_png(str(ours), img)
    jpng.write_png(str(ref), img)
    data = ours.read_bytes()
    assert data == ref.read_bytes()
    assert data == tpng.encode_png(tpng.quantize(img[::-1]))
    back = tpng.read_png(str(ours))
    np.testing.assert_array_equal(
        np.rint(back[..., :3] * 255).astype(np.uint8),
        tpng.quantize(img[::-1])[..., :3])


def test_write_png_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        tpng.write_png(str(tmp_path / "no" / "dir.png"),
                       np.zeros((2, 2, 3), np.float32))
    for bad in (np.zeros((2, 2, 3), np.uint8), np.zeros((2, 2, 4))):
        with pytest.raises(ValueError):
            bindings.write_png(str(tmp_path / "x.png"), bad)


def test_library_name_carries_the_source_hash(tmp_path, monkeypatch):
    lib = build.build()
    assert os.path.dirname(lib) == build.BUILD_DIR
    assert lib == build.library_path() == bindings.LIB_PATH() == build.OUT()
    src = tmp_path / "ptnative.cpp"
    src.write_bytes(open(build.SRC, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(build, "SRC", str(src))
    assert build.library_path() != lib


@pytest.fixture
def fresh_library(monkeypatch):
    """The library forgotten by this process before and after the test."""
    bindings._load.cache_clear()
    yield
    monkeypatch.undo()
    bindings._load.cache_clear()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch,
                                                   fresh_library):
    """A source g++ rejects: the build and every caller raise with the
    compiler's message; no loader falls back to the twin."""
    bad = tmp_path / "ptnative.cpp"
    bad.write_text("int pt_obj_counts( {\n")
    monkeypatch.setattr(build, "SRC", str(bad))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="error"):
        build.build()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tobj.load_obj(tbunny.ASSET_OBJ)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tpng.write_png(str(tmp_path / "x.png"),
                       np.zeros((2, 2, 3), np.float32))
    assert os.listdir(tmp_path / "_build") == []   # no temporary left


def test_missing_compiler_raises(tmp_path, monkeypatch, fresh_library):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        bindings.available()


def test_concurrent_builds(tmp_path):
    """Six processes build into one empty directory at once, as six test
    workers may: each gets the same complete library, and no temporary
    file is left."""
    out = tmp_path / "_build"
    code = ("import sys; from pathtracer_tpu_torch.native import build; "
            "build.BUILD_DIR = sys.argv[1]; print(build.build())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    results = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, results
    paths = {r[0].strip() for r in results}
    assert len(paths) == 1
    assert os.listdir(out) == [os.path.basename(paths.pop())]
    assert hasattr(ctypes.CDLL(str(out / os.listdir(out)[0])), "pt_obj_load")


@pytest.fixture
def native_calls(monkeypatch):
    """Counts of the native library's load_obj and write_png calls."""
    calls = {"load_obj": 0, "write_png": 0}
    for name in calls:
        real = getattr(bindings, name)

        def spy(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(bindings, name, spy)
    return calls


def test_mesh_loads_go_through_the_library(tmp_path, monkeypatch,
                                           native_calls):
    """The bunny, the Cornell room from PT_CORNELL_DIR, and the combined
    preset each parse their OBJ files natively."""
    tbunny.bunny_world(device="cpu")
    assert native_calls["load_obj"] == 1
    for name in ("floor", "left", "right", "light", "shortbox", "tallbox"):
        verts, faces = cornell_mesh(name)
        with open(tmp_path / f"{name}.obj", "w") as f:
            f.writelines(f"v {x!r} {y!r} {z!r}\n" for x, y, z in
                         verts.tolist())
            f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in
                         faces.tolist())
    monkeypatch.setenv("PT_CORNELL_DIR", str(tmp_path))
    scene, _ = tcornell.cornell_box(device="cpu")
    assert native_calls["load_obj"] == 7
    monkeypatch.delenv("PT_CORNELL_DIR")
    assert scene.num_prims == tcornell.cornell_box(device="cpu")[0].num_prims
    tpresets.combined_scene(device="cpu")
    assert native_calls["load_obj"] == 8


def test_cli_image_goes_through_the_library(tmp_path, native_calls):
    out = tmp_path / "t.png"
    assert tcli.main(["--scene", "test", "--width", "8", "--height", "4",
                      "--spp", "1", "--max-depth", "1", "--ray-chunk", "32",
                      "--device", "cpu", "-o", str(out)]) == 0
    assert native_calls["write_png"] == 1
    assert tpng.read_png(str(out)).shape == (4, 8, 4)


def _root_conftest():
    """The root ``conftest.py``, loaded by its path: ``import conftest``
    would be ambiguous beside ``tests/conftest.py``."""
    spec = importlib.util.spec_from_file_location(
        "_root_conftest", os.path.join(ROOT, "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def reference_builds(monkeypatch):
    """Calls of the reference's ``build``, which only counts them."""
    calls = []
    monkeypatch.setattr(jbuild, "build", lambda **kw: calls.append(kw))
    return calls


def test_prebuild_hook_skips_workers(reference_builds):
    worker = types.SimpleNamespace(workerinput={"workerid": "gw0"})
    _root_conftest().pytest_configure(worker)
    assert reference_builds == []


def test_prebuild_hook_builds_once_in_the_controller(reference_builds):
    _root_conftest().pytest_configure(types.SimpleNamespace())
    assert reference_builds == [{"quiet": True}]


@pytest.mark.parametrize("error", [
    FileNotFoundError("g++"),                  # no compiler
    subprocess.CalledProcessError(1, ["g++"]),  # no zlib, or g++ fails
])
def test_prebuild_hook_swallows_a_failed_build(error, monkeypatch):
    def fail(**kw):
        raise error
    monkeypatch.setattr(jbuild, "build", fail)
    _root_conftest().pytest_configure(types.SimpleNamespace())


def test_reference_library_loads():
    """With a compiler on the host, the reference's library loads in every
    test process: the 20 tests of ``test_torch_obj.py`` that compare with
    it must run, not skip."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the reference's library cannot "
                    "be built")
    assert jbindings.available()
