"""The reference bounce and its loops: the port of distributed_raytracer_tpu/
ops/trace.py.

A wavefront of rays carries (origin, direction, attenuation, color,
active); one bounce intersects every ray (intersect_fn: the dense
closest_hit, K11's closest_hit_pallas or a culled intersect), scatters
the hits with the key's draws and finishes misses (sky times attenuation)
and absorbs (black).  Rays still active after max_depth bounces
contribute black.  Both loops draw bounce i from split(key, max_depth)[i],
as JAX's do, so the two give the same colors.

trace_rays is differentiable by autograd (the scene fields and the rays
may require grad).  JAX wraps each bounce in jax.checkpoint (`remat`) to
keep the scan's residuals small; eager autograd keeps each bounce's
tensors and has no such switch, so the port has no `remat`.  early_skip
skips the bounces after every ray has finished, as JAX's lax.cond does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core import vecmath as vm
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops import materials
from distributed_raytracer_tpu_torch.ops.intersect import closest_hit

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


def sky_color(ray_d: torch.Tensor) -> torch.Tensor:
    """White-to-blue background gradient by the direction's height."""
    unit_d = vm.unit_vector(ray_d)
    a = 0.5 * (unit_d[..., 1] + 1.0)
    white = torch.tensor(SKY_WHITE, dtype=ray_d.dtype, device=ray_d.device).expand(ray_d.shape)
    blue = torch.tensor(SKY_BLUE, dtype=ray_d.dtype, device=ray_d.device).expand(ray_d.shape)
    return vm.lerp(white, blue, a)


class RayState(NamedTuple):
    """The wavefront carry; an inactive lane's color is final."""

    origin: torch.Tensor       # [R, 3]
    direction: torch.Tensor    # [R, 3]
    attenuation: torch.Tensor  # [R, 3]
    color: torch.Tensor        # [R, 3]
    active: torch.Tensor       # [R] bool


def init_state(ray_o: torch.Tensor, ray_d: torch.Tensor) -> RayState:
    r = ray_o.shape[0]
    f = dict(dtype=ray_o.dtype, device=ray_o.device)
    return RayState(origin=ray_o, direction=ray_d, attenuation=torch.ones(r, 3, **f),
                    color=torch.zeros(r, 3, **f),
                    active=torch.ones(r, dtype=torch.bool, device=ray_o.device))


def bounce_step(state: RayState, key: torch.Tensor, scene: Scene,
                intersect_fn=closest_hit, row0: int = 0) -> RayState:
    """One masked bounce of the whole wavefront (rows row0.. of a larger
    one when row0 is given: the draws are that wavefront's)."""
    hit_res = intersect_fn(state.origin, state.direction, scene)
    # a miss carries t = BIG, which would overflow the scatter's hit point
    # (and its NaNs would leak into gradients): give misses a safe t
    t_safe = torch.where(hit_res.hit, hit_res.t, 1.0)
    sc = materials.scatter(key, state.origin, state.direction, t_safe, hit_res.idx, scene,
                           row0=row0)

    finish_miss = state.active & ~hit_res.hit
    keep_going = state.active & hit_res.hit & sc.scattered

    sky = sky_color(state.direction)
    color = torch.where(finish_miss[:, None], state.attenuation * sky, state.color)
    # an absorbed ray contributes black: its color stays at zero
    kg = keep_going[:, None]
    return RayState(
        origin=torch.where(kg, sc.origin, state.origin),
        direction=torch.where(kg, sc.direction, state.direction),
        attenuation=torch.where(kg, state.attenuation * sc.attenuation, state.attenuation),
        color=color,
        active=keep_going,
    )


def trace_rays(scene: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor, key: torch.Tensor,
               max_depth: int, intersect_fn=closest_hit, early_skip: bool = True,
               row0: int = 0) -> torch.Tensor:
    """Differentiable fixed-depth trace; returns colors [R, 3].  row0: the
    rays are rows row0.. of a larger batch and draw as its rows do."""
    state = init_state(ray_o, ray_d)
    keys = prng.split(key, max_depth)
    for i in range(max_depth):
        if early_skip and not bool(state.active.any()):
            break
        state = bounce_step(state, keys[i], scene, intersect_fn, row0)
    return state.color


def trace_rays_fast(scene: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor,
                    key: torch.Tensor, max_depth: int, intersect_fn=closest_hit,
                    row0: int = 0) -> torch.Tensor:
    """Forward-only trace that stops once every ray has finished: trace_rays
    without autograd (the same draws and colors)."""
    with torch.no_grad():
        return trace_rays(scene, ray_o, ray_d, key, max_depth, intersect_fn, row0=row0)
