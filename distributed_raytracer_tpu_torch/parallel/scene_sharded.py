"""Sphere-axis sharding: the port of distributed_raytracer_tpu/parallel/
scene_sharded.py on torch.distributed.

The scene's sphere axis is split into equal blocks over the mesh's
"scene" axis (shard_scene pads it with spheres of radius 0 and the ABSORB
material, which never hit).  Every rank of a row intersects the row's
whole ray wavefront against its block (K11 on the card, the plain dense
closest hit on the CPU); one all-gather of the per-block (t, local index)
gives the global closest hit, the least t over the blocks, a tie going to
the lowest global index (block * n_local + local index) as the dense
sweep's first least does; the winner's parameters come back by one masked
sum over the row, to which only the owning block adds.  So every bounce
makes collectives inside it, and the ranks of a row run in lockstep as
real processes (several on one card through gloo).

Noise: sample s of rays shard a draws from fold_in(fold_in(key, s), a);
the ranks of one row share every draw.

Gradients: the ranks of a row compute the same function of the gathered
hits and parameters, so each holds the whole cotangent of them; the
transposes (parallel/mesh.py) hand each rank its own block of it (the
all-gather) or pass it through (the masked sum).  A bounce's rays feed
every block's sweep, so their cotangent is summed over the row, and the
blocks' scene cotangents are summed over the rays axis.  Grads come back
in the rank's own block.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.core.vecmath import BIG
from distributed_raytracer_tpu_torch.models.scene import ABSORB, Scene
from distributed_raytracer_tpu_torch.ops import materials
from distributed_raytracer_tpu_torch.ops.camera import Camera, generate_rays
from distributed_raytracer_tpu_torch.ops.intersect import HitResult, candidate_ts
from distributed_raytracer_tpu_torch.ops.trace import RayState, init_state, sky_color
from distributed_raytracer_tpu_torch.parallel.mesh import (
    RAYS_AXIS,
    SCENE_AXIS,
    Mesh,
    axis_gather,
    axis_sum,
    gather_blocks,
    pad_to_multiple,
    replicate,
    sum_blocks,
)

_DIFF = ("centers", "radii", "albedo", "fuzz", "ior")
_FIELDS = ("centers", "radii", "albedo", "mat_type", "fuzz", "ior")


def closest_hit_sharded(ray_o: torch.Tensor, ray_d: torch.Tensor, scene_shard: Scene,
                        mesh: Mesh, local_intersect=None) -> HitResult:
    """The global closest hit from each rank's block of the scene: global
    sphere indices (block * n_local + local index).  local_intersect(o, d,
    scene) -> HitResult sweeps the block (e.g. K11's closest_hit_pallas);
    None: the dense [R, n_local] candidate_ts.  Differentiable in t: the
    rays are replicated over the row, and their cotangent sums every
    block's part of it (a block's own t reaches only its own spheres)."""
    if torch.is_grad_enabled() and (ray_o.requires_grad or ray_d.requires_grad):
        ray_o, ray_d = replicate([ray_o, ray_d], mesh, SCENE_AXIS)
    if local_intersect is not None:
        loc = local_intersect(ray_o, ray_d, scene_shard)
        t_loc, i_loc = loc.t, loc.idx
    else:
        t_loc, i_loc = torch.min(candidate_ts(ray_o, ray_d, scene_shard), dim=-1)
    t_all = gather_blocks(t_loc[None], mesh, SCENE_AXIS)               # [S, R]
    i_all = axis_gather(i_loc.to(torch.int32), mesh, SCENE_AXIS)       # [S, R]
    t, winner = torch.min(t_all, dim=0)  # the first least: the lowest block
    idx_local = torch.gather(i_all, 0, winner[None])[0]
    idx = winner.to(torch.int32) * scene_shard.num_spheres + idx_local
    return HitResult(t=t, idx=idx, hit=t < BIG * 0.5)


def gather_params_sharded(scene_shard: Scene, idx_global: torch.Tensor, mesh: Mesh) -> dict:
    """The winning spheres' attributes by one masked sum over the row: the
    block owning the winner adds its values, every other adds zeros.  All
    ten attributes travel in one [R, 10] payload (mat_type as float32,
    exact for the small codes)."""
    n_local = scene_shard.num_spheres
    owner = idx_global.long() // n_local
    mine = owner == mesh.scene_index
    local_idx = torch.where(mine, idx_global.long() - owner * n_local, 0)
    stacked = torch.cat([
        scene_shard.centers,                                  # 0:3
        scene_shard.radii[:, None],                           # 3
        scene_shard.albedo,                                   # 4:7
        scene_shard.fuzz[:, None],                            # 7
        scene_shard.ior[:, None],                             # 8
        scene_shard.mat_type.to(torch.float32)[:, None],      # 9
    ], dim=-1)
    g = sum_blocks(stacked[local_idx] * mine.to(stacked.dtype)[:, None], mesh, SCENE_AXIS)
    return dict(centers=g[:, 0:3], radii=g[:, 3], albedo=g[:, 4:7],
                mat=g[:, 9].to(torch.int32), fuzz=g[:, 7], ior=g[:, 8])


def bounce_step_sharded(state: RayState, key: torch.Tensor, scene_shard: Scene, mesh: Mesh,
                        local_intersect=None) -> RayState:
    """One masked bounce with the scene sharded: ops/trace.py's
    bounce_step around the two collectives."""
    hit_res = closest_hit_sharded(state.origin, state.direction, scene_shard, mesh,
                                  local_intersect)
    params = gather_params_sharded(scene_shard, hit_res.idx, mesh)
    t_safe = torch.where(hit_res.hit, hit_res.t, 1.0)
    # a ray that missed every block gathered zeros: make ior and radius safe
    params["ior"] = torch.where(hit_res.hit, params["ior"], 1.0)
    params["radii"] = torch.where(hit_res.hit, params["radii"], 1.0)
    sc = materials.scatter_gathered(key, state.origin, state.direction, t_safe, params)

    finish_miss = state.active & ~hit_res.hit
    keep_going = state.active & hit_res.hit & sc.scattered
    color = torch.where(finish_miss[:, None], state.attenuation * sky_color(state.direction),
                        state.color)
    kg = keep_going[:, None]
    return RayState(
        origin=torch.where(kg, sc.origin, state.origin),
        direction=torch.where(kg, sc.direction, state.direction),
        attenuation=torch.where(kg, state.attenuation * sc.attenuation, state.attenuation),
        color=color,
        active=keep_going,
    )


def trace_rays_sharded(scene_shard: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor,
                       key: torch.Tensor, max_depth: int, mesh: Mesh,
                       local_intersect=None) -> torch.Tensor:
    """Fixed-depth trace with the scene sharded over the row; stops once
    every ray of the row has finished (the row's ranks agree on it)."""
    state = init_state(ray_o, ray_d)
    keys = prng.split(key, max_depth)
    for i in range(max_depth):
        if not bool(state.active.any()):
            break
        state = bounce_step_sharded(state, keys[i], scene_shard, mesh, local_intersect)
    return state.color


def shard_scene(scene: Scene, n_shards: int) -> Scene:
    """Pad the sphere axis to a multiple of n_shards with spheres that
    never hit (radius 0, ABSORB), so the blocks are equal."""
    n = scene.num_spheres
    pad = pad_to_multiple(n, n_shards) - n
    if pad == 0:
        return scene
    dev = scene.centers.device

    def cat(x, fill, row=()):
        return torch.cat([x, torch.full((pad,) + row, fill, dtype=x.dtype, device=dev)])

    return Scene(centers=cat(scene.centers, 0.0, (3,)), radii=cat(scene.radii, 0.0),
                 albedo=cat(scene.albedo, 0.0, (3,)), mat_type=cat(scene.mat_type, ABSORB),
                 fuzz=cat(scene.fuzz, 0.0), ior=cat(scene.ior, 1.0))


def scene_block(scene: Scene, mesh: Mesh) -> Scene:
    """This rank's block of a padded scene."""
    n_local = scene.num_spheres // mesh.n_scene
    if n_local * mesh.n_scene != scene.num_spheres:
        raise ValueError(f"{scene.num_spheres} spheres do not split over {mesh.n_scene} "
                         "blocks: pad the scene with shard_scene first")
    k = mesh.scene_index
    return Scene(**{f: getattr(scene, f)[k * n_local:(k + 1) * n_local] for f in _FIELDS})


def _rays_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    r = x.shape[0]
    if r % mesh.n_rays:
        raise ValueError(f"{r} rays do not split over {mesh.n_rays} ranks")
    s = r // mesh.n_rays
    return x[mesh.rays_index * s:(mesh.rays_index + 1) * s]


def _trace_sample_sum_local(scene_shard: Scene, key: torch.Tensor,
                            sample_indices: Iterable[int], ids: torch.Tensor, camera: Camera,
                            depth: int, mesh: Mesh, local_intersect=None) -> torch.Tensor:
    """Sum of per-sample colors of this rank's rays: sample s draws from
    fold_in(fold_in(key, s), rays index), shared by the row."""
    w = camera.image_width
    acc = torch.zeros(ids.shape[0], 3, dtype=torch.float32, device=ids.device)
    for s in sample_indices:
        k = prng.fold_in(prng.fold_in(key, int(s)), mesh.rays_index)
        k_cam, k_trace = prng.split(k)
        o, d = generate_rays(camera, ids % w, ids // w, key=k_cam)
        acc = acc + trace_rays_sharded(scene_shard, o, d, k_trace, depth, mesh,
                                       local_intersect)
    return acc


def _default_local_intersect(local_intersect, dev: torch.device):
    """"auto": K11 (closest_hit_pallas) on the card, the plain dense
    closest hit on the CPU."""
    if local_intersect != "auto":
        return local_intersect
    if dev.type == "cuda":
        from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import (
            closest_hit_pallas,
        )

        return closest_hit_pallas
    return None


def make_scene_sharded_render(mesh: Mesh, camera: Camera, max_depth: Optional[int] = None,
                              local_intersect="auto", device=None):
    """The 2D (rays x scene) render: render(padded_scene, key,
    sample_indices, ids) -> color sums [len(ids) / n_rays, 3] of this
    rank's rows of ids, over the samples, with the scene sharded over the
    row.  ids: the padded pixel ids of every rank (a multiple of n_rays);
    padded_scene: shard_scene's, the same on every rank."""
    depth = max_depth if max_depth is not None else camera.max_depth
    dev = resolve_device(device)
    cam = camera.to(dev)
    li = _default_local_intersect(local_intersect, dev)

    def render(padded_scene: Scene, key, sample_indices, ids):
        block = scene_block(padded_scene.to(dev), mesh)
        with torch.no_grad():
            return _trace_sample_sum_local(block, key, sample_indices,
                                           _rays_block(ids.to(dev), mesh), cam, depth, mesh, li)

    return render


def make_tape_2d_tracer(mesh: Mesh, key: torch.Tensor, max_depth: int, pool: int = 2048,
                        budget=None, refill_every: int = 1, local_intersect="auto",
                        device=None):
    """The host-loop tape tracer (grad/tapegrad.py::make_tape_tracer) over
    the 2D mesh: f(padded_scene, ray_o [R, 3], ray_d [R, 3]) -> colors of
    this rank's rays shard, [R / n_rays, 3].  Each pool row sweeps the
    rank's block (local_intersect), one all-gather and a min give the
    global winner, and the shading and the tape read the gathered
    parameter table; the backward replays against it and hands each rank
    the cotangents of its own block, summed over the rays axis (they land
    in padded_scene's rows of that block).  The row's ranks share the
    draws (fold_in(key, rays index)), and the per-sphere sweep is the
    replicated one's, so the colors, tapes and gradients are those of the
    rays-dp tracer with the same intersect on the whole padded scene."""
    from distributed_raytracer_tpu_torch.grad.tapegrad import make_tape_tracer

    dev = resolve_device(device)
    li = _default_local_intersect(local_intersect, dev)

    def isect(ro, rd, scene_f: Scene) -> HitResult:
        # the winner only: the tape's backward never differentiates the sweep
        return closest_hit_sharded(ro, rd, scene_block(scene_f, mesh), mesh, li)

    tracer = make_tape_tracer(key, max_depth, pool=pool, intersect_fn=isect, budget=budget,
                              refill_every=refill_every, device=dev)

    def f(padded_scene: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor) -> torch.Tensor:
        block = scene_block(padded_scene.to(dev), mesh)
        leaves = replicate([getattr(block, k) for k in _DIFF], mesh, RAYS_AXIS)
        full = {k: gather_blocks(x, mesh, SCENE_AXIS) for k, x in zip(_DIFF, leaves)}
        scene_full = Scene(mat_type=gather_blocks(block.mat_type, mesh, SCENE_AXIS), **full)
        return tracer(scene_full, _rays_block(ray_o, mesh), _rays_block(ray_d, mesh),
                      prng.fold_in(key, mesh.rays_index))

    return f


def make_scene_sharded_grad_fn(mesh: Mesh, camera: Camera, max_depth: Optional[int] = None,
                               device=None):
    """(loss, grads) over the 2D mesh: grad_fn(padded_scene, key,
    sample_indices, target [n_pix, 3]) -> (the mean squared error over the
    whole image, this rank's block of the five fields' gradients).  The
    sweep is the dense candidate_ts (differentiable in t), as in JAX."""
    depth = max_depth if max_depth is not None else camera.max_depth
    dev = resolve_device(device)
    cam = camera.to(dev)
    n_pix = camera.num_pixels
    m = pad_to_multiple(n_pix, mesh.n_rays)
    ids = torch.zeros(m, dtype=torch.int64, device=dev)
    ids[:n_pix] = torch.arange(n_pix, device=dev)
    weight = (torch.arange(m, device=dev) < n_pix).to(torch.float32)

    def grad_fn(padded_scene: Scene, key, sample_indices, target):
        samples = list(sample_indices)
        block = scene_block(padded_scene.to(dev), mesh)
        leaves = {k: getattr(block, k).detach().requires_grad_() for k in _DIFF}
        rep = dict(zip(_DIFF, replicate(list(leaves.values()), mesh, RAYS_AXIS)))
        shard = Scene(mat_type=block.mat_type, **rep)
        tgt = torch.zeros(m, 3, dtype=torch.float32, device=dev)
        tgt[:n_pix] = torch.as_tensor(target, dtype=torch.float32).reshape(-1, 3).to(dev)
        total = _trace_sample_sum_local(shard, key, samples, _rays_block(ids, mesh), cam, depth,
                                        mesh)
        img = total / len(samples)
        se = torch.sum((img - _rays_block(tgt, mesh)) ** 2, dim=-1) * _rays_block(weight, mesh)
        loss = torch.sum(se) / (3.0 * n_pix)  # this rank's term of the whole image's mean
        loss.backward()
        return axis_sum(loss.detach(), mesh, RAYS_AXIS), {k: v.grad for k, v in leaves.items()}

    return grad_fn
