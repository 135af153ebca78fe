"""The port's hash draws are bit-identical to the JAX _hash_u01."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.pallas.culled_bounce_kernel import _hash_u01
from distributed_raytracer_tpu_torch.ops.kernels.hash import hash_u01, wrap_i32

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,d", [
    (123456, 0),
    (-987654321, 9),               # a negative int32 seed
    (123456 + 50 * 65537, 4),      # a depth-50 bounce seed
])
def test_hash_bit_exact_on_2_20_ids(seed, d):
    # 2^20 ids spread over the whole int32 range, negatives included
    ids = ((np.arange(2**20, dtype=np.int64) * 4099 + 17) % 2**32 - 2**31).astype(np.int32)
    want = np.asarray(_hash_u01(jnp.asarray(ids), jnp.int32(seed), d))
    got = hash_u01(torch.from_numpy(ids.astype(np.int64)), seed, d).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_hash_seed_as_tensor_and_uint32_ids():
    ids = np.arange(4096, dtype=np.int64) + 2**31 + 5   # above int32: read as uint32
    seeds = np.full(4096, -7, np.int64)
    want = np.asarray(_hash_u01(jnp.asarray(ids.astype(np.uint32).view(np.int32)),
                                jnp.int32(-7), 2))
    got = hash_u01(torch.from_numpy(ids), torch.from_numpy(seeds), 2).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= np.float32(1e-7) and got.max() <= np.float32(1.0 - 1e-7)


def test_wrap_i32():
    assert wrap_i32(2**31) == -(2**31)
    assert wrap_i32(-1) == -1
    assert wrap_i32(123456 + 50 * 65537) == 123456 + 50 * 65537
    assert wrap_i32(2**32 + 3) == 3
