"""Counter-mode integer hash draws: the plain PyTorch version of
distributed_raytracer_tpu/ops/pallas/culled_bounce_kernel.py::_hash_u01,
bit-identical to it.  The CUDA device function is csrc/hash.cuh.

The JAX version wraps int32 multiplies.  Here every value is an int64
holding the uint32 bit pattern, and each 32x32-bit multiply is split into
two 16x32-bit halves so no int64 product can overflow."""

from __future__ import annotations

from typing import Union

import torch

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9   # int32 -1640531527
_C2 = 0xC2B2AE35       # int32 -1028477387
_C3 = 0x85EBCA6B       # int32 -2048144789


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 values x (int64 tensor) and constant c."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def hash_u01(rid: torch.Tensor, seed: Union[int, torch.Tensor], d: int) -> torch.Tensor:
    """Uniform (0, 1) f32 draws from (ray id, seed, draw index).  rid and
    seed are read as 32-bit patterns (negative int32 seeds wrap as in
    JAX); the result is clipped to [1e-7, 1 - 1e-7]."""
    x = rid.to(torch.int64) & _MASK32
    s = (seed & _MASK32) if isinstance(seed, int) else seed.to(torch.int64) & _MASK32
    h = (_mul32(x, _GOLDEN) + s + ((d * _C2) & _MASK32)) & _MASK32
    h = h ^ ((h & 0x7FFFFFFF) >> 16)
    h = _mul32(h, _C3)
    h = h ^ ((h & 0x7FFFFFFF) >> 13)
    h = _mul32(h, _C2)
    h = h ^ ((h & 0x7FFFFFFF) >> 16)
    u = (h & 0x007FFFFF).to(torch.float32) * (1.0 / 8388608.0)
    return torch.clamp(u, 1e-7, 1.0 - 1e-7)


def wrap_i32(x: int) -> int:
    """A Python int as the int32 it wraps to."""
    return ((int(x) + 2**31) % 2**32) - 2**31
