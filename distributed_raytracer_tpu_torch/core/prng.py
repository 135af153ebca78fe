"""JAX's threefry keys in torch: the same bits from the same seed.

The port's copy of the partitionable threefry generator that JAX uses
(jax/_src/prng.py: threefry_seed, _threefry_split_foldlike,
_threefry_fold_in, _threefry_random_bits_partitionable; jax/_src/
random.py: _uniform, _normal_real, _randint).  A key is a [2] int64
tensor on the CPU holding two uint32 words; split gives [n, 2].  The
integer work is int64 masked to 32 bits (torch's uint32 lacks most
operations), so PRNGKey, split, fold_in, random_bits, uniform and randint
equal JAX's bit for bit.  The *_keys functions take a batch of keys
[B, 2] (on any device) and do per key what the one-key functions do:
JAX's vmap of fold_in, split, random_bits, uniform and normal.

normal is sqrt(2) * erf_inv(u) with u uniform on (nextafter(-1, 0), 1),
and erf_inv is XLA's float32 polynomial (Giles' coefficients, two
branches over w = -log1p(-x^2)), not torch.erfinv, which lands up to
61 ulp from it; this one stays within a few ulp of JAX's (XLA:CPU may
contract the polynomial's multiply-adds).

One key is derived on the host (a handful of Python integer
operations); random_bits, what is drawn from it and the batched keys run
on the requested device.
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


def _iota_words(n: int, device, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit iota offset..offset+n-1 as its (hi, lo) uint32 words."""
    iota = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return iota >> 32, iota & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num) -> [num, 2]: the hash of the 64-bit iota."""
    k1, k2 = _words(key)
    hi, lo = _iota_words(num, "cpu")
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape, device="cpu", offset: int = 0) -> torch.Tensor:
    """32 random bits per element of shape, as int64 in [0, 2^32): the
    hash of the flattened shape's 64-bit iota, its two words XORed.  offset
    starts the iota there: the elements offset.. of a larger draw from the
    same key (each element's bits depend on its flat index alone, as in
    JAX's partitionable threefry), which is how a shard of rows draws its
    part of the whole batch's draws."""
    shape = _shape(shape)
    k1, k2 = _words(key)
    hi, lo = _iota_words(math.prod(shape), device, offset)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(shape)


def _uniform_of_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """23 random mantissa bits under the exponent of 1.0, minus 1, scaled
    to [minval, maxval)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0,
            device="cpu", offset: int = 0) -> torch.Tensor:
    """jax.random.uniform in float32 (offset: as random_bits)."""
    return _uniform_of_bits(random_bits(key, shape, device, offset), minval, maxval)


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


def _normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """sqrt(2) * erf_inv(u), u uniform on (nextafter(-1, 0), 1)."""
    u = _uniform_of_bits(bits, _NORMAL_LO, 1.0)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=bits.device) * erf_inv(u)


def normal(key: torch.Tensor, shape: Shape = (), device="cpu", offset: int = 0) -> torch.Tensor:
    """jax.random.normal in float32 (offset: as random_bits)."""
    return _normal_of_bits(random_bits(key, shape, device, offset))


_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


def _mul32(a, b: int):
    """a * b mod 2^32 for a in [0, 2^32) (an int or an int64 tensor) and
    b < 2^32, in int64 without overflow: b in 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & _M32) << 16
    return (lo + hi) & _M32


def _bits_pair(key: torch.Tensor, shape: Shape, device):
    """(higher, lower): random_bits of the two keys of split(key), as
    Python ints for shape () (the seeds a tracer draws per call, without
    a tensor operation on the host), else as tensors."""
    if _shape(shape) == ():
        k1, k2 = _words(key)
        keys = [threefry2x32(k1, k2, 0, i) for i in (0, 1)]
        return tuple(b1 ^ b2 for b1, b2 in (threefry2x32(a, b, 0, 0) for a, b in keys))
    k1, k2 = split(key)
    return random_bits(k1, shape, device), random_bits(k2, shape, device)


def randint(key: torch.Tensor, shape: Shape = (), minval: int = 0, maxval: int = _I32_MAX,
            device="cpu") -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) of dtype int32 (JAX's
    default with 64-bit types off; random.py _randint): two 32-bit draws
    from split(key), higher and lower, folded into the unsigned span by
    ((higher mod span) * ((2^16 mod span)^2 mod span) + (lower mod span))
    mod span, every product and sum wrapping at 2^32; span 1 where maxval
    <= minval.  minval and maxval are int32, as JAX requires there.
    Returns int64 holding the int32 values."""
    lo, hi = int(minval), int(maxval)
    if not (_I32_MIN <= lo <= _I32_MAX and _I32_MIN <= hi <= _I32_MAX):
        raise ValueError(f"minval {lo} and maxval {hi} must be int32")
    span = 1 if hi <= lo else hi - lo
    higher, lower = _bits_pair(key, shape, device)
    mult = ((2**16 % span) ** 2 & _M32) % span
    off = ((_mul32(higher % span, mult) + lower % span) & _M32) % span
    # minval + int32(offset), wrapping as int32 does
    v = (lo + off) & _M32
    if isinstance(v, int):
        return torch.tensor(v - 2**32 if v > _I32_MAX else v, dtype=torch.int64, device=device)
    return torch.where(v > _I32_MAX, v - 2**32, v)


SEED_MAX = 2**31 - 1
CAM_FOLD = 0xCA3


def seed_pair(key: torch.Tensor) -> Tuple[int, int]:
    """JAX's (bounce_seed, cam_seed) of a key (mega_render_kernel.py:549-554):
    randint(key, (), 0, 2^31 - 1) and the same of fold_in(key, 0xCA3)."""
    return (int(randint(key, (), 0, SEED_MAX)),
            int(randint(fold_in(key, CAM_FOLD), (), 0, SEED_MAX)))


def bounce_seed(key: torch.Tensor) -> int:
    """The int32 bounce seed JAX's kernel paths take from a key:
    randint(key, (), 0, 2^31 - 1) (tapegrad.py:184, pathgrad.py:283)."""
    return int(randint(key, (), 0, SEED_MAX))


# ---- batches of keys: JAX's vmap over [B] keys ----

def _as_words(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def check_key(key) -> torch.Tensor:
    """key, if it is one key (a [2] integer tensor, as PRNGKey makes);
    else TypeError (an int seed, say, where a key belongs)."""
    if not (torch.is_tensor(key) and key.numel() == 2 and not key.is_floating_point()):
        raise TypeError(f"expected a key of two uint32 words (prng.PRNGKey(seed)), got {key!r}")
    return key


def keys_of(key: torch.Tensor, device) -> torch.Tensor:
    """One key as a [1, 2] batch on device."""
    return key.reshape(1, 2).to(device)


def fold_in_keys(keys: torch.Tensor, data) -> torch.Tensor:
    """vmap(fold_in)(keys [B, 2], data [B] or one int) -> [B, 2]."""
    d = _as_words(data, keys.device)
    b1, b2 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def split_keys(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """vmap(split)(keys [B, 2], num) -> [B, num, 2]."""
    hi, lo = _iota_words(num, keys.device)
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], hi[None], lo[None])
    return torch.stack([b1, b2], dim=-1)


def random_bits_keys(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """vmap(random_bits)(keys [B, 2], shape) -> int64 [B, *shape]."""
    shape = _shape(shape)
    hi, lo = _iota_words(math.prod(shape), keys.device)
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], hi[None], lo[None])
    return (b1 ^ b2).reshape((keys.shape[0],) + shape)


def uniform_keys(keys: torch.Tensor, shape: Shape = (), minval: float = 0.0,
                 maxval: float = 1.0) -> torch.Tensor:
    """vmap(uniform)(keys [B, 2], shape) in float32 -> [B, *shape]."""
    return _uniform_of_bits(random_bits_keys(keys, shape), minval, maxval)


def normal_keys(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """vmap(normal)(keys [B, 2], shape) in float32 -> [B, *shape]."""
    return _normal_of_bits(random_bits_keys(keys, shape))
