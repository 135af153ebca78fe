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


# ---- randint and JAX's seeds of a batch (F2), and the batched keys ----

RANGES = [(0, 2**31 - 1), (-7, 13), (5, 5), (10, 3), (-2**31, 2**31 - 1), (3, 1000003),
          (0, 65536), (-1000, 2**30 + 12345)]


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_equals_jax(seed):
    """Bit for bit over key and range: the span arithmetic wraps at 2^32
    (the full int32 span and spans near 2^31 exercise every mask)."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for data in (0, 3, 0xCA3):
        jkk, tkk = jax.random.fold_in(jk, data), prng.fold_in(tk, data)
        for lo, hi in RANGES:
            for shape in ((), (64,)):
                want = np.asarray(jax.random.randint(jkk, shape, lo, hi)).astype(np.int64)
                np.testing.assert_array_equal(prng.randint(tkk, shape, lo, hi).numpy(), want)
    # JAX refuses bounds past int32 (an OverflowError with 64-bit types off)
    with pytest.raises(ValueError, match="int32"):
        prng.randint(tk, (), 0, 2**31)


def _jax_pair(seed, done):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), done)
    return (int(jax.random.randint(k, (), 0, 2**31 - 1)),
            int(jax.random.randint(jax.random.fold_in(k, 0xCA3), (), 0, 2**31 - 1)))


@pytest.mark.parametrize("seed", SEEDS + [-(2**40), 2**45 + 9])
def test_batch_seeds_equal_jax(seed):
    from distributed_raytracer_tpu_torch.render.progressive import batch_seeds

    for done in (0, 1, 16, 50, 499):
        assert batch_seeds(seed, done) == _jax_pair(seed, done), (seed, done)
    assert prng.seed_pair(prng.fold_in(prng.PRNGKey(seed), 4)) == _jax_pair(seed, 4)


def test_batched_keys_equal_jax_vmap():
    """fold_in, split, random_bits, uniform, normal and the samplers over a
    [B, 2] batch of keys against JAX's vmaps: bit for bit, normal within
    test_normal_within_three_ulp's 3 ulp."""
    jk, tk = jax.random.PRNGKey(9), prng.PRNGKey(9)
    ids = np.arange(300, dtype=np.uint32) * 7919
    jkeys = jax.vmap(lambda r: jax.random.fold_in(jk, r))(jnp.asarray(ids))
    tkeys = prng.fold_in_keys(prng.keys_of(tk, "cpu"), torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_array_equal(tkeys.numpy(), _words(jkeys))
    np.testing.assert_array_equal(prng.fold_in_keys(tkeys, 5).numpy(),
                                  _words(jax.vmap(lambda k: jax.random.fold_in(k, 5))(jkeys)))
    for num in (2, 3):
        np.testing.assert_array_equal(prng.split_keys(tkeys, num).numpy(),
                                      _words(jax.vmap(lambda k: jax.random.split(k, num))(jkeys)))
    np.testing.assert_array_equal(
        prng.random_bits_keys(tkeys, (4,)).numpy(),
        _words(jax.vmap(lambda k: jax.random.bits(k, (4,), jnp.uint32))(jkeys)))
    np.testing.assert_array_equal(
        prng.uniform_keys(tkeys).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(jkeys)))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,), jnp.float32))(jkeys))
    assert _ulps(prng.normal_keys(tkeys, (3,)), want).max() <= 3
    want = np.asarray(jax.vmap(lambda k: jrng.unit_vector(k, ()))(jkeys))
    np.testing.assert_allclose(trng.unit_vector_keys(tkeys).numpy(), want, rtol=0, atol=1e-6)
    # one key split into a batch, as the host-loop tape tracer draws a row
    np.testing.assert_array_equal(prng.split_keys(prng.keys_of(tk, "cpu"), 50)[0].numpy(),
                                  _words(jax.random.split(jk, 50)))


@pytest.fixture(scope="module")
def tiny_engines():
    """A 9x6 image of the final scene at depth 3, its 600-sphere field
    version past 512 and its culled version, for the engines that take
    batch_seeds."""
    from distributed_raytracer_tpu_torch.models import presets
    from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import build_culled_scene

    torch.set_num_threads(2)
    scene = presets.rtiow_final_scene(seed=0, pad_to=512)
    camera = presets.final_scene_camera(9).replace(max_depth=3)
    field = presets.random_sphere_field(600, seed=5, extent=30.0)
    return scene, camera, field, build_culled_scene(scene, chunk=128)


@pytest.mark.parametrize("seed", [0, -3, 2**32 + 5])
def test_engines_draw_jax_seeds(tiny_engines, seed):
    """render_progressive at seed s renders each batch with JAX's pair of
    fold_in(PRNGKey(s), samples_done): the mega, walk and culled fused
    engines equal their sums at JAX's pair, bit for bit (the kernels are
    held to JAX at explicit seeds by the other port tests)."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk
    from distributed_raytracer_tpu_torch.render import progressive
    from distributed_raytracer_tpu_torch.render.order import tile_permutation
    from distributed_raytracer_tpu_torch.render.wavefront import render_wavefront_sum_fused

    scene, camera, field, culled = tiny_engines
    kw = dict(spp=2, batch=1, device="cpu")
    pairs = [_jax_pair(seed, 0), _jax_pair(seed, 1)]

    def both(fn):
        return (fn(1, *pairs[0]) + fn(1, *pairs[1])).numpy()

    got = progressive.render_progressive(scene, camera, seed=seed, engine="mega", **kw)
    want = both(lambda n, b, c: mrk.render_wavefront_sum_mega(scene, camera, n, b, c,
                                                              device="cpu"))
    np.testing.assert_array_equal(got.raw_sum, want)
    got = progressive.render_progressive(field, camera, seed=seed, engine="mega", **kw)
    pack = mwk.walk_pack_for(field, camera, chunk=256)
    want = both(lambda n, b, c: mwk.render_wavefront_sum_mega_walk(pack, camera, n, b, c,
                                                                   device="cpu"))
    np.testing.assert_array_equal(got.raw_sum, want)
    got = progressive.render_progressive(culled.scene, camera, seed=seed, engine="fused",
                                         culled=culled, ray_order="tiled", pool_size=64, **kw)
    perm = tile_permutation(camera.image_width, camera.image_height)
    want = both(lambda n, b, c: render_wavefront_sum_fused(
        culled.scene, camera, n, b, c, pool_size=64, culled=culled, pixel_perm=perm,
        device="cpu"))
    np.testing.assert_array_equal(got.raw_sum, want)
