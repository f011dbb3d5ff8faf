"""PyTorch/CUDA port of ``pathtracer_tpu`` (slice 1: the bunny render).

The JAX package ``pathtracer_tpu`` is the reference; this package computes
the same forward render in PyTorch and runs the cluster march as a CUDA
kernel written for Hopper (``csrc/cluster_march.cu``). It imports neither
``jax`` nor ``pathtracer_tpu``. Layout mirrors the reference package so each
module's counterpart is easy to find.
"""

__version__ = "0.1.0"
