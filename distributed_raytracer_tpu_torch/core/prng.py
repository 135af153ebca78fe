"""JAX's threefry keys in torch: the same bits from the same seed.

The port's copy of the partitionable threefry generator that JAX uses
(jax/_src/prng.py: threefry_seed, _threefry_split_foldlike,
_threefry_fold_in, _threefry_random_bits_partitionable; jax/_src/
random.py: _uniform, _normal_real).  A key is a [2] int64 tensor on the
CPU holding two uint32 words; split gives [n, 2].  The integer work is
int64 masked to 32 bits (torch's uint32 lacks most operations), so
PRNGKey, split, fold_in, random_bits and uniform equal JAX's bit for bit.

normal is sqrt(2) * erf_inv(u) with u uniform on (nextafter(-1, 0), 1),
and erf_inv is XLA's float32 polynomial (Giles' coefficients, two
branches over w = -log1p(-x^2)), not torch.erfinv, which lands up to
61 ulp from it; this one stays within a few ulp of JAX's (XLA:CPU may
contract the polynomial's multiply-adds).

Keys are derived on the host (a handful of Python integer operations);
only random_bits and what is drawn from it run on the requested device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def threefry2x32(k1, k2, x0, x1):
    """The threefry-2x32 hash of the count words (x0, x1) under the key
    words (k1, k2): Python ints or int64 tensors holding uint32 values.
    JAX's unrolled lowering (prng.py _threefry2x32_lowering): 20 rounds,
    a key injection after every four."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k = key.reshape(2).tolist()
    return int(k[0]), int(k[1])


def _key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([k1, k2], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey(seed) as JAX runs by default (64-bit types off):
    the seed becomes a 32-bit integer, so the words are (0, seed mod 2^32)
    (threefry_seed's (seed >> 32, seed & 0xFFFFFFFF) of that integer)."""
    return _key(0, int(seed) & _M32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data): the hash of the words (0, uint32(data))."""
    k1, k2 = _words(key)
    return _key(*threefry2x32(k1, k2, 0, int(data) & _M32))


def _iota_words(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit iota 0..n-1 as its (hi, lo) uint32 words."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, iota & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num) -> [num, 2]: the hash of the 64-bit iota."""
    k1, k2 = _words(key)
    hi, lo = _iota_words(num, "cpu")
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape, device="cpu") -> torch.Tensor:
    """32 random bits per element of shape, as int64 in [0, 2^32): the
    hash of the flattened shape's 64-bit iota, its two words XORed."""
    shape = _shape(shape)
    k1, k2 = _words(key)
    hi, lo = _iota_words(math.prod(shape), device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """jax.random.uniform in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, f * (hi - lo) + lo)


# XLA's float32 erf_inv (ErfInv32): Horner coefficients, highest degree
# first, for w < 5 and for w >= 5
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv polynomial on a float32 tensor."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERF_INV_LT5[0], _ERF_INV_GE5[0])
    for a, b in zip(_ERF_INV_LT5[1:], _ERF_INV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape: Shape = (), device="cpu") -> torch.Tensor:
    """jax.random.normal in float32: sqrt(2) * erf_inv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=device) * erf_inv(u)
