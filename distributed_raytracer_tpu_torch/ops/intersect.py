"""Batched closest-hit ray x sphere intersection, dense over the scene:
the port of distributed_raytracer_tpu/ops/intersect.py.

Every ray's candidate t on every sphere as a dense [R, N] array (the
half-b quadratic, near root before far, strict T_MIN < t < t_max), the
closest by argmin.  This is JAX's *expanded* form: d.c and o.c are
[R, 3] x [3, N] products (torch.matmul, as JAX leaves them to XLA outside
any kernel; a float32 matmul on the card is full float32 unless TF32 is
switched on, which the port never does), and |c - o|^2 is expanded
around them.  ops/kernels/intersect_kernel.py (K11) computes the same
closest hit in the oc form, c - o first; the two agree to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_raytracer_tpu_torch.core import vecmath as vm
from distributed_raytracer_tpu_torch.core.vecmath import BIG, T_MIN
from distributed_raytracer_tpu_torch.models.scene import Scene


class HitResult(NamedTuple):
    """The closest hit of each ray, before the shading gathers."""

    t: torch.Tensor    # [R] f32 distance of the closest valid hit (BIG if none)
    idx: torch.Tensor  # [R] int32 index of the winning sphere (0 if none)
    hit: torch.Tensor  # [R] bool


def candidate_ts(ray_o: torch.Tensor, ray_d: torch.Tensor, scene: Scene,
                 t_min: float = T_MIN, t_max: float = BIG) -> torch.Tensor:
    """All valid hit distances as a dense [R, N] array (BIG where invalid):
    h = d.c - d.o, c_q = (|c|^2 - r^2) - 2 o.c + |o|^2, disc = h^2 - a c_q.
    The sqrt sees a safe value on the miss branch (its gradient at 0 is
    infinite), and spheres of radius <= 0 (padding) never hit."""
    centers_t = scene.centers.t()
    d_dot_c = torch.matmul(ray_d, centers_t)
    o_dot_c = torch.matmul(ray_o, centers_t)

    a = vm.dot(ray_d, ray_d)[:, None]
    d_dot_o = vm.dot(ray_d, ray_o)[:, None]
    o_norm2 = vm.dot(ray_o, ray_o)[:, None]
    c_norm2_minus_r2 = vm.dot(scene.centers, scene.centers) - scene.radii * scene.radii

    h = d_dot_c - d_dot_o
    c_q = c_norm2_minus_r2[None, :] - 2.0 * o_dot_c + o_norm2

    disc = h * h - a * c_q
    safe_disc = torch.where(disc > 0.0, disc, 1.0)
    sqrtd = torch.where(disc > 0.0, torch.sqrt(safe_disc), 0.0)
    inv_a = 1.0 / a
    root_near = (h - sqrtd) * inv_a
    root_far = (h + sqrtd) * inv_a

    real = (scene.radii > 0.0)[None, :]
    ok = (disc >= 0.0) & real
    near_valid = ok & (root_near > t_min) & (root_near < t_max)
    far_valid = ok & (root_far > t_min) & (root_far < t_max)
    return torch.where(near_valid, root_near, torch.where(far_valid, root_far, BIG))


def closest_hit(ray_o: torch.Tensor, ray_d: torch.Tensor, scene: Scene,
                t_min: float = T_MIN, t_max: float = BIG) -> HitResult:
    """Closest hit over the whole scene: the first minimum of candidate_ts."""
    t, idx = torch.min(candidate_ts(ray_o, ray_d, scene, t_min, t_max), dim=-1)
    return HitResult(t=t, idx=idx.to(torch.int32), hit=t < BIG)
