"""Root test configuration: build the reference's native library once,
before any xdist worker starts.

``pathtracer_tpu/native/build.py`` writes g++'s output in place, and each
worker's first mesh load would start that build; a worker that loads the
half-written file keeps "no library" for its whole life. Nothing is
imported at module level, so ``tests/conftest.py`` still sets the JAX
platform before anything could import jax.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    import subprocess

    from pathtracer_tpu.native.build import build
    try:
        build(quiet=True)
    except (OSError, subprocess.CalledProcessError):
        # no g++ or zlib: the tests that need the library skip, as before
        pass
