"""The random draws the traced paths are keyed by, written out for the
reference: the counter-mode hash that gives each (ray, seed, index) a
uniform, and the threefry-2x32 arithmetic by which a render request's seed
becomes the (bounce, camera) seed pair of a batch of samples.

This is a frozen copy of the arithmetic, not of any module of the program:
the hash is the murmur-style finalizer of the book renderer's TPU port
(draw = 23 mantissa bits of the mixed word, clipped away from 0 and 1),
and the threefry part is JAX's documented PRNG (PRNGKey, fold_in, split,
randint with 64-bit types off), which the program follows bit for bit.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_C2 = 0xC2B2AE35
_C3 = 0x85EBCA6B
DEPTH_STRIDE = 65537  # the bounce seed of depth k is seed + k * 65537 (int32 wrap)
CAM_DRAW0 = 8         # camera draws use indices 8..11, bounce draws 0..4
SEED_MAX = 2**31 - 1
CAM_FOLD = 0xCA3


def wrap_i32(x: int) -> int:
    return ((int(x) + 2**31) % 2**32) - 2**31


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    # (x * c) mod 2^32 in int64 without overflow: x split in 16-bit halves
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & M32


def hash_u01(rid: torch.Tensor, seed, d: int) -> torch.Tensor:
    """float32 uniforms in [1e-7, 1 - 1e-7] for ray ids rid (int64, read as
    uint32), a seed (an int or an int64 tensor like rid, read as uint32)
    and the draw index d."""
    x = rid & M32
    h = (_mul32(x, _GOLDEN) + (seed & M32) + ((d * _C2) & M32)) & M32
    h = h ^ ((h & 0x7FFFFFFF) >> 16)
    h = _mul32(h, _C3)
    h = h ^ ((h & 0x7FFFFFFF) >> 13)
    h = _mul32(h, _C2)
    h = h ^ ((h & 0x7FFFFFFF) >> 16)
    u = (h & 0x7FFFFF).to(torch.float32) * (1.0 / 8388608.0)
    return torch.clamp(u, 1e-7, 1.0 - 1e-7)


# ---- JAX's threefry PRNG on Python ints ----

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry(k1: int, k2: int, x0: int, x1: int):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int):
    return (0, int(seed) & M32)


def fold_in(key, data: int):
    return threefry(key[0], key[1], 0, int(data) & M32)


def randint_nonneg(key, maxval: int) -> int:
    """jax.random.randint(key, (), 0, maxval) for 0 < maxval < 2^31."""
    halves = [threefry(key[0], key[1], 0, i) for i in (0, 1)]
    higher, lower = (a ^ b for a, b in (threefry(k1, k2, 0, 0) for k1, k2 in halves))
    span = maxval
    mult = ((2**16 % span) ** 2 & M32) % span
    return ((((higher % span) * mult & M32) + lower % span) & M32) % span


def batch_seeds(seed: int, samples_done: int):
    """(bounce_seed, cam_seed) of the batch of samples that starts at
    samples_done, for a progressive render with this seed."""
    k = fold_in(prng_key(seed), samples_done)
    return randint_nonneg(k, SEED_MAX), randint_nonneg(fold_in(k, CAM_FOLD), SEED_MAX)
