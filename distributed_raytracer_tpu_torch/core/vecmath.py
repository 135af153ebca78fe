"""Constants and trailing-dim-3 vector helpers (the port's copy of
distributed_raytracer_tpu/core/vecmath.py:19-63, in float32 torch)."""

from __future__ import annotations

import torch

# The reference uses 1e-8 on f64; 1e-6 is the f32-representable stand-in
# for "numerically degenerate scatter direction".
NEAR_ZERO_EPS = 1e-6

# Strictly-positive lower bound on ray t (shadow acne guard).
T_MIN = 1e-3

# Stand-in for +inf that survives arithmetic without producing NaNs.
BIG = 1e30


def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, summed x + y + z left to right."""
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
            u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
            u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
        ],
        dim=-1,
    )


def unit_vector(v: torch.Tensor) -> torch.Tensor:
    """Normalize over the trailing axis; zero-length input gives zero."""
    norm2 = dot(v, v)
    safe = torch.where(norm2 > 0.0, norm2, torch.ones_like(norm2))
    inv = torch.where(norm2 > 0.0, torch.rsqrt(safe), torch.zeros_like(norm2))
    return v * inv[..., None]
