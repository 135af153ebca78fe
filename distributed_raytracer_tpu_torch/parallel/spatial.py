"""Spatial scene sharding, grid cells to scene blocks: the port of
distributed_raytracer_tpu/parallel/spatial.py.

The spheres are grouped by the x/z grid cells they overlap (models/aabb.py
grid_cells), the cells split into contiguous ranges over the blocks, a
sphere copied into every block whose cells it overlaps, and every block
padded to one size.  The collective closest hit (parallel/scene_sharded.py)
is unchanged: copies resolve to the same winning t, and the masked
parameter sum is copy-safe.
"""

from __future__ import annotations

from typing import List

import numpy as np

from distributed_raytracer_tpu_torch.models.aabb import AABB, grid_cells, intersect_sphere
from distributed_raytracer_tpu_torch.models.scene import ABSORB, Scene


def shard_scene_spatial(scene: Scene, n_shards: int, n_x: int = 6, n_z: int = 6) -> Scene:
    """A scene whose sphere axis is [n_shards * shard_size]: block k holds
    the real spheres overlapping its range of grid cells (cell c goes to
    block c * n_shards // n_cells), padded with spheres that never hit.  A
    sphere overlapping no cell goes to block 0.  A CPU scene."""
    cells = grid_cells(n_x=n_x, n_z=n_z)
    n_cells = cells.lo.shape[0]
    a = scene.to_numpy()
    radii = a["radii"]
    overlap = intersect_sphere(AABB(lo=cells.lo[:, None, :], hi=cells.hi[:, None, :]),
                               scene.centers.detach().cpu()[None, :, :],
                               scene.radii.detach().cpu()[None, :]).numpy()  # [n_cells, N]

    all_cells = np.arange(n_cells)
    per_shard: List[np.ndarray] = []
    for k in range(n_shards):
        mask = overlap[all_cells[(all_cells * n_shards) // n_cells == k]].any(axis=0)
        idx = np.where(mask)[0]
        per_shard.append(idx[radii[idx] > 0])  # real spheres; padding added below

    covered = np.zeros(len(radii), bool)
    for idx in per_shard:
        covered[idx] = True
    orphans = np.where(~covered & (radii > 0))[0]
    if len(orphans):
        per_shard[0] = np.concatenate([per_shard[0], orphans])

    shard_size = max(max(len(i) for i in per_shard), 1)

    def block(idx: np.ndarray) -> dict:
        pad = shard_size - len(idx)

        def take(x, fill):
            return np.concatenate([x[idx], np.full((pad,) + x.shape[1:], fill, x.dtype)])

        return dict(centers=take(a["centers"], 0.0), radii=take(a["radii"], 0.0),
                    albedo=take(a["albedo"], 0.0), mat_type=take(a["mat_type"], ABSORB),
                    fuzz=take(a["fuzz"], 0.0), ior=take(a["ior"], 1.0))

    blocks = [block(i) for i in per_shard]
    return Scene.from_numpy({k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]},
                            device="cpu")
