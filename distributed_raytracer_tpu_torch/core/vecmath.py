"""Constants and trailing-dim-3 vector helpers (the port's copy of
distributed_raytracer_tpu/core/vecmath.py, in float32 torch)."""

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


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where all three components are below NEAR_ZERO_EPS in magnitude."""
    return (v.abs() < NEAR_ZERO_EPS).all(dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection about the unit normal n."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, etai_over_etat) -> torch.Tensor:
    """Snell refraction of the unit vector uv about the unit normal n;
    etai_over_etat broadcasts over the batch.  The sqrt takes a safe
    value where its argument is 0, so its gradient stays finite."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    eta = torch.as_tensor(etai_over_etat)[..., None]
    r_out_perp = eta * (uv + cos_theta[..., None] * n)
    k = torch.abs(1.0 - length_squared(r_out_perp))
    safe_k = torch.where(k > 0.0, k, 1.0)
    r_out_parallel = -torch.where(k > 0.0, torch.sqrt(safe_k), 0.0)[..., None] * n
    return r_out_perp + r_out_parallel


def lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(1 - t) * a + t * b, t broadcast over the trailing axis."""
    t = torch.as_tensor(t)[..., None]
    return (1.0 - t) * a + t * b
