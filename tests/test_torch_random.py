"""The port's threefry2x32 against ``jax.random``: bit-equal float32
uniforms over the renderer's whole key chain (partitionable threefry, the
JAX 0.9 default)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.core import random as prng

torch.set_num_threads(1)


def _words(key):
    return tuple(int(x) for x in np.asarray(key))


def test_partitionable_mode():
    # the port reproduces the partitionable stream only
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2 ** 31 - 1])
def test_key_fold_in_split(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _words(jk) == tk
    for data in (0, 1, 5, 57600, 2 ** 31 - 1):
        assert _words(jax.random.fold_in(jk, data)) == prng.fold_in(tk,
                                                                     data)
    jsplit = jax.random.split(jax.random.fold_in(jk, 3), 4)
    tsplit = prng.split(prng.fold_in(tk, 3), 4)
    assert [_words(k) for k in jsplit] == tsplit


@pytest.mark.parametrize("shape", [(1,), (7,), (2, 450), (2, 512), (3, 5, 4)])
def test_uniform_bits(shape):
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    a = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    b = prng.uniform(tk, shape, "cpu").numpy()
    assert b.dtype == np.float32 and b.shape == shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("m", [1, 6])
def test_uniform_by_ray(m):
    jk = jax.random.fold_in(jax.random.PRNGKey(4), 2)
    rng = np.random.default_rng(0)
    rid = rng.permutation(1000).astype(np.int32)[:300]
    keys = jax.vmap(lambda r: jax.random.fold_in(jk, r))(jnp.asarray(rid))
    ju = jax.vmap(lambda kk: jax.random.uniform(kk, (m,)))(keys)
    tu = prng.uniform_by_ray(_words(jk), torch.from_numpy(rid), m)
    assert np.array_equal(np.asarray(ju), tu.numpy())


@pytest.mark.parametrize("seed,chunk,n_chunks", [(0, 512, 2), (5, 450, 1),
                                                 (99, 128, 3)])
def test_renderer_key_chain(seed, chunk, n_chunks):
    """The renderer's chain: fold_in(base, s) -> fold_in(., first pixel)
    -> split(., 4) -> jitter/lens/time uniforms, and per bounce
    fold_in(trace key, depth) -> per-ray uniforms."""
    jbase, tbase = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    rid = np.arange(chunk, dtype=np.int32)[::-1].copy()
    for s in range(2):
        jskey, tskey = jax.random.fold_in(jbase, s), prng.fold_in(tbase, s)
        for c in range(n_chunks):
            jck = jax.random.fold_in(jskey, c * chunk)
            tck = prng.fold_in(tskey, c * chunk)
            jkeys = jax.random.split(jck, 4)
            tkeys = prng.split(tck, 4)
            assert [_words(k) for k in jkeys] == tkeys
            for shape, k in (((2, chunk), 0), ((2, chunk), 2),
                             ((chunk,), 3)):
                assert np.array_equal(
                    np.asarray(jax.random.uniform(jkeys[k], shape,
                                                  jnp.float32)),
                    prng.uniform(tkeys[k], shape, "cpu").numpy())
            for depth in range(3):
                jb = jax.random.fold_in(jkeys[1], depth)
                tb = prng.fold_in(tkeys[1], depth)
                keys = jax.vmap(lambda r: jax.random.fold_in(jb, r))(
                    jnp.asarray(rid))
                ju = jax.vmap(lambda kk: jax.random.uniform(kk, (6,)))(keys)
                tu = prng.uniform_by_ray(tb, torch.from_numpy(rid), 6)
                assert np.array_equal(np.asarray(ju), tu.numpy())
