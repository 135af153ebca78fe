"""The port's native host runtime (native.py) against the JAX package's
ctypes wrapper of the same C++ library, bit for bit, on the CPU; the
port's NumPy fallbacks (no C++ compiler) against the C++ library, bit for
bit; render/image.py's pack_argb against JAX's."""

import numpy as np
import pytest

from distributed_raytracer_tpu import native as jnative
from distributed_raytracer_tpu.render import image as jimage
from distributed_raytracer_tpu_torch import native
from distributed_raytracer_tpu_torch.render import image


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), "g++ builds native/dray_native.cpp for the port"
    assert jnative.available(), "make -C native builds the JAX package's library"


@pytest.fixture
def no_compiler(monkeypatch):
    """The port as on a host with no C++ compiler: every entry point runs
    its NumPy fallback."""
    monkeypatch.setattr(native, "_load", lambda: None)


def _colors(shape, seed=0):
    """Linear colors over the tonemap's every branch: negative, zero,
    inside (0, 1), past the 0.999 clamp, and inf."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(-0.2, 1.3, shape).astype(np.float32)
    flat = rgb.reshape(-1)
    flat[:6] = [0.0, -0.0, 1.0, 0.998001, np.inf, 0.25]
    return rgb


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 3), (1296, 0), (10007, 12345),
                                    (810000, 2**31 - 2), (257, 2**64 - 1), (100, -5)])
def test_shuffled_indices_match_jax_and_fallback(n, seed):
    got = native.shuffled_indices(n, seed)
    np.testing.assert_array_equal(got, jnative.shuffled_indices(n, seed))
    np.testing.assert_array_equal(np.sort(got), np.arange(n))
    fallback = native._shuffle_numpy(np.arange(n, dtype=np.int32), seed)
    assert fallback.dtype == np.int32
    np.testing.assert_array_equal(fallback, got)


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("shape", [(7, 3), (27, 48, 3)])
def test_tonemaps_and_pack_match_jax(request, fallback, shape):
    if fallback:
        request.getfixturevalue("no_compiler")
    rgb = _colors(shape)
    got_b, want_b = native.tonemap_bytes(rgb), jnative.tonemap_bytes(rgb)
    assert got_b.dtype == np.uint8 and got_b.shape == shape
    np.testing.assert_array_equal(got_b, want_b)
    got_p, want_p = native.tonemap_pack(rgb), jnative.tonemap_pack(rgb)
    assert got_p.dtype == np.uint32 and got_p.shape == shape[:-1]
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(image.pack_argb(rgb), jimage.pack_argb(rgb))
    np.testing.assert_array_equal(image.pack_argb(rgb), want_p)


@pytest.mark.parametrize("fallback", [False, True])
def test_accumulate_and_mean_pack_match_jax(request, fallback):
    if fallback:
        request.getfixturevalue("no_compiler")
    rng = np.random.default_rng(1)
    n_pix = 500
    ids = rng.integers(-3, n_pix + 3, 2000).astype(np.int32)  # repeats, and ids out of range
    colors = _colors((2000, 3), seed=2)
    colors[np.isinf(colors)] = 2.0
    outs = []
    for lib in (native, jnative):
        raw = np.zeros((n_pix, 3), np.float32)
        count = np.zeros(n_pix, np.int32)
        lib.accumulate(raw, count, colors[:1000], ids[:1000])
        lib.accumulate(raw, count, colors[1000:], ids[1000:])
        outs.append((raw, count, lib.mean_pack(raw, count)))
    (raw, count, packed), (j_raw, j_count, j_packed) = outs
    np.testing.assert_array_equal(raw, j_raw)
    np.testing.assert_array_equal(count, j_count)
    assert (count == 0).any() and count.max() > 2
    np.testing.assert_array_equal(packed, j_packed)
    # the C++ library's pack, whichever side ran here
    np.testing.assert_array_equal(packed, jnative.mean_pack(j_raw, j_count))


def test_accumulate_refuses_bad_buffers():
    raw = np.zeros((4, 3), np.float64)
    with pytest.raises(ValueError, match="float32"):
        native.accumulate(raw, np.zeros(4, np.int32), np.zeros((1, 3)), [0])
    with pytest.raises(ValueError, match="colors for"):
        native.accumulate(np.zeros((4, 3), np.float32), np.zeros(4, np.int32),
                          np.zeros((2, 3)), [0])
