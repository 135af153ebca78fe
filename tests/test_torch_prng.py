"""The port's threefry keys (core/prng.py) and samplers (core/rng.py)
against jax.random, on the same seeds.

PRNGKey, split, fold_in, random_bits and uniform equal JAX's bit for bit
(uniform on ranges whose scaling is exact; elsewhere XLA:CPU fuses
f * (hi - lo) + lo into one multiply-add: within the product's rounding).
normal is sqrt(2) * erf_inv(u) on the same uniforms; erf_inv is XLA's
float32 polynomial written in torch ops, which lands within 2 ulp of
XLA's own evaluation (measured: 2 ulp on 5.2% of 200,000 inputs, the
log1p and the multiply-adds rounded apart), and the multiply by sqrt(2)
adds one rounding: within 3 ulp (measured 3 on 4.7%).  torch.erfinv, by
contrast, lands up to 61 ulp away.  The samplers built on them
(unit_vector, in_unit_disk, square_jitter) are held to a few ulp of
their values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.core import rng as jrng
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core import rng as trng

torch.set_num_threads(1)
SEEDS = [0, 1, 7, 123456, 2**31 - 1, -5, 2**32 + 1]
SHAPES = [(1000,), (7, 3), (33, 2)]


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _words(jax_key):
    return np.asarray(jax_key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for n in (2, 3, 50):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(), _words(jax.random.split(jk, n)))
    for data in (0, 1, 17, 2**31 + 5):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                      _words(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_equal_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(),
                                  _words(jax.random.bits(jk, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-0.5, 0.5), (0.0, 2.0 * np.pi)):
        np.testing.assert_array_equal(prng.uniform(tk, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                                                    lo, hi)))


def test_normal_within_three_ulp():
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    u = prng.uniform(tk, (200000,), prng._NORMAL_LO, 1.0)
    assert _ulps(prng.erf_inv(u), jax.lax.erf_inv(jnp.asarray(u.numpy()))).max() <= 2
    got = prng.normal(tk, (200000,))
    want = np.asarray(jax.random.normal(jk, (200000,), jnp.float32))
    assert _ulps(got, want).max() <= 3
    # torch's own erfinv is no stand-in for XLA's polynomial
    assert _ulps(np.sqrt(np.float32(2)) * torch.erfinv(u).numpy(), want).max() > 3


@pytest.mark.parametrize("seed", [0, 9])
def test_samplers_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(trng.uniform(tk, 64).numpy(),
                                  np.asarray(jrng.uniform(jk, 64)))
    # f * (hi - lo) + lo: XLA:CPU fuses it into one multiply-add, torch
    # rounds the product first (at most half an ulp of a product below 5),
    # which is exact wherever the product is (the ranges above)
    np.testing.assert_allclose(trng.uniform_range(tk, -2.0, 3.0, (4, 5)).numpy(),
                               np.asarray(jrng.uniform_range(jk, -2.0, 3.0, (4, 5))),
                               rtol=0, atol=2.5e-7)
    np.testing.assert_array_equal(trng.square_jitter(tk, 300).numpy(),
                                  np.asarray(jrng.square_jitter(jk, 300)))
    # a normalized normal draw: a few ulp of the unit components
    np.testing.assert_allclose(trng.unit_vector(tk, 300).numpy(),
                               np.asarray(jrng.unit_vector(jk, 300)), rtol=0, atol=1e-6)
    # sqrt, cos and sin of the same uniforms
    np.testing.assert_allclose(trng.in_unit_disk(tk, 300).numpy(),
                               np.asarray(jrng.in_unit_disk(jk, 300)), rtol=0, atol=1e-6)
