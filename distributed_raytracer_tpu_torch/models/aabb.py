"""Axis-aligned bounding boxes: the port of distributed_raytracer_tpu/
models/aabb.py (the correct three-axis slab test and the sphere overlap
test).  Used by parallel/spatial.py to shard a scene by grid cell."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from distributed_raytracer_tpu_torch.core.vecmath import BIG


class AABB(NamedTuple):
    lo: torch.Tensor  # [..., 3]
    hi: torch.Tensor  # [..., 3]


def intersect_sphere(box: AABB, center, radius) -> torch.Tensor:
    """True where the sphere overlaps the box: the closest point of the
    box to the center lies within the radius.  Broadcasts box [..., 3]
    against center [..., 3] and radius [...]."""
    center = torch.as_tensor(center)
    closest = torch.minimum(torch.maximum(center, box.lo), box.hi)
    d2 = torch.sum((center - closest) ** 2, dim=-1)
    return d2 <= torch.as_tensor(radius) ** 2


def hit_interval(box: AABB, ray_o: torch.Tensor, ray_d: torch.Tensor,
                 t_min: float = 1e-3, t_max: float = BIG
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three-axis slab test: (hit, t_enter, t_exit), batched over rays
    [R, 3] against boxes that broadcast."""
    inv_d = 1.0 / torch.where(ray_d.abs() > 1e-30, ray_d, 1e-30)
    t0 = (box.lo - ray_o) * inv_d
    t1 = (box.hi - ray_o) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_enter = torch.clamp_min(t_near, t_min)
    t_exit = torch.clamp_max(t_far, t_max)
    return t_enter <= t_exit, t_enter, t_exit


def grid_cells(n_x: int = 6, n_z: int = 6,
               x_range: Tuple[float, float] = (-12.0, 12.0),
               z_range: Tuple[float, float] = (-12.0, 12.0),
               overlap: float = 2.0, edge_extent: float = 1e6) -> AABB:
    """An x/z grid of overlapping slabs unbounded in y, the edge cells
    extended to +/- edge_extent: an AABB batch [n_x * n_z, 3]."""
    xs = np.linspace(x_range[0], x_range[1], n_x + 1)
    zs = np.linspace(z_range[0], z_range[1], n_z + 1)
    lo, hi = [], []
    for i in range(n_x):
        for k in range(n_z):
            x0, x1 = xs[i] - overlap, xs[i + 1] + overlap
            z0, z1 = zs[k] - overlap, zs[k + 1] + overlap
            if i == 0:
                x0 = -edge_extent
            if i == n_x - 1:
                x1 = edge_extent
            if k == 0:
                z0 = -edge_extent
            if k == n_z - 1:
                z1 = edge_extent
            lo.append((x0, -edge_extent, z0))
            hi.append((x1, edge_extent, z1))
    return AABB(lo=torch.tensor(np.asarray(lo), dtype=torch.float32),
                hi=torch.tensor(np.asarray(hi), dtype=torch.float32))
