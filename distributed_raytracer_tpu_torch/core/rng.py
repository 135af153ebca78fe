"""Closed-form batched samplers on threefry keys: the port of
distributed_raytracer_tpu/core/rng.py.

Each sampler draws from core/prng.py's keys with JAX's shapes, so every
draw is JAX's draw (bit for bit for the uniforms, within a few ulp where a
normal or a cos/sin enters).  `device` says where the draws are made;
`row0` draws rows row0.. of a batch that starts at row 0 (a shard's part
of the whole batch's draws, as JAX's sharded draws give each device).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from distributed_raytracer_tpu_torch.core import prng

Shape = Union[int, Sequence[int]]


def _shape(batch_shape: Shape) -> Tuple[int, ...]:
    return (batch_shape,) if isinstance(batch_shape, int) else tuple(batch_shape)


def _offset(shape: Tuple[int, ...], row0: int) -> int:
    """The flat index of row row0 of shape's leading axis."""
    return row0 * math.prod(shape[1:]) if shape else 0


def uniform(key: torch.Tensor, batch_shape: Shape = (), device="cpu", row0: int = 0
            ) -> torch.Tensor:
    """U[0, 1) draws in float32."""
    shp = _shape(batch_shape)
    return prng.uniform(key, shp, device=device, offset=_offset(shp, row0))


def uniform_range(key: torch.Tensor, lo: float, hi: float, batch_shape: Shape = (),
                  device="cpu") -> torch.Tensor:
    """U[lo, hi) draws in float32."""
    return prng.uniform(key, _shape(batch_shape), lo, hi, device=device)


def _normalized(g: torch.Tensor) -> torch.Tensor:
    norm2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2])[..., None]
    return g * torch.rsqrt(torch.clamp_min(norm2, 1e-20))


def unit_vector(key: torch.Tensor, batch_shape: Shape = (), device="cpu", row0: int = 0
                ) -> torch.Tensor:
    """Uniform direction on the unit sphere, [*batch, 3]: a normalized
    [*batch, 3] gaussian draw."""
    shp = _shape(batch_shape) + (3,)
    return _normalized(prng.normal(key, shp, device=device, offset=_offset(shp, row0)))


def unit_vector_keys(keys: torch.Tensor) -> torch.Tensor:
    """vmap(lambda k: unit_vector(k, ()))(keys [B, 2]) -> [B, 3]."""
    return _normalized(prng.normal_keys(keys, (3,)))


def in_unit_disk(key: torch.Tensor, batch_shape: Shape = (), device="cpu", row0: int = 0
                 ) -> torch.Tensor:
    """Uniform point in the unit disk (z = 0), [*batch, 3], by the
    sqrt-polar map: r = sqrt(u1), theta = 2 pi u2."""
    ku, kv = prng.split(key)
    shp = _shape(batch_shape)
    off = _offset(shp, row0)
    r = torch.sqrt(prng.uniform(ku, shp, device=device, offset=off))
    theta = prng.uniform(kv, shp, 0.0, 2.0 * math.pi, device=device, offset=off)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                        torch.zeros(shp, dtype=torch.float32, device=device)], dim=-1)


def square_jitter(key: torch.Tensor, batch_shape: Shape = (), device="cpu", row0: int = 0
                  ) -> torch.Tensor:
    """Random offset in [-0.5, 0.5)^2 (z = 0), [*batch, 3]."""
    shp = _shape(batch_shape)
    xy = prng.uniform(key, shp + (2,), -0.5, 0.5, device=device,
                      offset=_offset(shp + (2,), row0))
    return torch.cat([xy, torch.zeros(shp + (1,), dtype=torch.float32, device=device)], dim=-1)
