"""Host-side scene prep for the chunk walk: spheres reordered into
spatially tight chunks, each with a bounding sphere.

Port of the host half of the JAX package's ops/pallas/culled_kernel.py
(`CulledScene`, `build_culled_scene`).  Spheres of radius >= big_threshold
(the ground sphere) go into leading chunks whose bound is infinite, so
every walk sweeps them; the rest are Morton-ordered by the native cluster
builder (distributed_raytracer_tpu_torch/native.py) and padded with -1
slots to a multiple of the chunk.  The walk (K9) and the culled fused
bounce (K14) read a CulledScene through their packs
(mega_walk_kernel.py::build_walk_pack, culled_bounce_kernel.py::
build_culled_pack).  The block-culled closest-hit kernels of that file are
not part of the port yet (ROADMAP Queue 2, K12 and K13).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_raytracer_tpu_torch import native
from distributed_raytracer_tpu_torch.models.scene import ABSORB, Scene

LANE = 128
GROUP = 8  # bound rows are padded to whole groups of this many (the TPU's flag tests)


class CulledScene(NamedTuple):
    """A Scene reordered for the chunk walk, and its chunk bounds."""

    scene: Scene            # chunk-ordered, padded to n_chunks * chunk (CPU tensors)
    bounds_c: np.ndarray    # [n_chunks, 3] f32 bound centers
    bounds_r2: np.ndarray   # [n_chunks] f32 bound radius^2 (inf: always swept)
    chunk: int              # spheres per chunk
    order: np.ndarray       # [n_chunks * chunk] int64 original index per slot, -1 padding


def build_culled_scene(scene: Scene, chunk: int = LANE,
                       big_threshold: float = 50.0) -> CulledScene:
    """Reorder a scene into walk chunks (culled_kernel.py:61-134): the big
    spheres first, in always-swept chunks, then the rest in Morton order;
    spheres of radius <= 0 are left out."""
    centers = scene.centers.detach().cpu().numpy().astype(np.float32)
    radii = scene.radii.detach().cpu().numpy().astype(np.float32)
    real = radii > 0
    big = real & (radii >= big_threshold)
    small_idx = np.where(real & ~big)[0]
    if len(small_idx):
        order_local, bounds = native.build_clusters(centers[small_idx], radii[small_idx], chunk)
        small_sorted = small_idx[order_local]
    else:
        small_sorted = small_idx
        bounds = np.zeros((0, 4), np.float32)

    big_idx = np.where(big)[0]
    n_big = -(-len(big_idx) // chunk)
    n_small = -(-len(small_sorted) // chunk)
    n_chunks = max(n_big + n_small, 1)

    def pad_ids(ids, n_chunks_for):
        return np.concatenate([ids, np.full(n_chunks_for * chunk - len(ids), -1, np.int64)])

    order = np.concatenate([pad_ids(big_idx, n_big),
                            pad_ids(small_sorted, max(n_small, 1 - n_big))])
    valid = torch.from_numpy(order >= 0)
    src = torch.from_numpy(np.clip(order, 0, len(radii) - 1))

    def take(x, fill):
        v = valid.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(v, x.detach().cpu()[src], torch.full_like(x.detach().cpu()[src], fill))

    reordered = Scene(centers=take(scene.centers, 0.0), radii=take(scene.radii, 0.0),
                      albedo=take(scene.albedo, 0.0), mat_type=take(scene.mat_type, ABSORB),
                      fuzz=take(scene.fuzz, 0.0), ior=take(scene.ior, 1.0))
    bc = np.zeros((n_chunks, 3), np.float32)
    br2 = np.full((n_chunks,), np.float32(np.inf))
    for c in range(min(n_small, len(bounds))):
        bc[n_big + c] = bounds[c, :3]
        br2[n_big + c] = bounds[c, 3] ** 2
    return CulledScene(scene=reordered, bounds_c=bc, bounds_r2=br2, chunk=chunk, order=order)
