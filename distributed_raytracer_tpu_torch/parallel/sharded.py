"""Ray/pixel data parallelism over the mesh's "rays" axis: the port of
distributed_raytracer_tpu/parallel/sharded.py on torch.distributed.

The pixels (or rays) are split into n_rays contiguous shards of s_loc =
ceil(n / n_rays); rank r of the axis owns pixels r * s_loc .. and the last
shards may hold fewer real pixels, or none.  The forward is embarrassingly
parallel: each rank renders its shard with the port's engines and kernels,
and the scene is replicated.  The only collectives are the sum of the
scene cotangents over the axis in the backward (`mesh.replicate`) and the
image fan-in (`multihost.gather_image`).

Each factory returns a function that runs this rank's shard, with
`.local(..., rank)` beside it: the same shard for a given rank, with no
collective, so one process can run every rank of a mesh in turn (one card
cannot hold two NCCL ranks).

Noise contracts, as in the JAX package:
  - bit for bit the single-device result whatever the mesh: the mega, walk
    and camera tracers and renders, whose draws are keyed by the global
    (ray id, depth) hash; and ShardedRenderer and make_sharded_grad_fn,
    whose sample s draws from fold_in(key, s) and whose rays take their
    rows of the whole image's draws (core/rng.py row0);
  - equal to single-device runs of each shard with fold_in(key, rank): the
    tape dp tracer and the fused dp render.

Dropped as TPU scheduling, as on the single-device tracers: block_rays,
mega_pad, segsum="matmul", pool and budget of the kernel tracers, variant.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import Camera, generate_rays
from distributed_raytracer_tpu_torch.ops.trace import trace_rays, trace_rays_fast
from distributed_raytracer_tpu_torch.parallel.mesh import (
    RAYS_AXIS,
    Mesh,
    axis_sum,
    pad_to_multiple,
    replicate,
)
from distributed_raytracer_tpu_torch.parallel.multihost import gather_image

_MASK32 = 0xFFFFFFFF
_DIFF = ("centers", "radii", "albedo", "fuzz", "ior")


def shard_size(n: int, n_shards: int) -> int:
    """s_loc: items per shard when n is split over n_shards (the last
    shards padded)."""
    return pad_to_multiple(n, n_shards) // n_shards


def shard_span(n: int, s_loc: int, rank: int) -> Tuple[int, int]:
    """(first item, real item count) of shard rank: the count is less than
    s_loc on a shard that runs past n, and 0 on one that starts past it."""
    start = rank * s_loc
    return start, max(0, min(s_loc, n - start))


def _padded_pixel_ids(camera: Camera, multiple: int, device) -> torch.Tensor:
    """[m] int64 pixel ids padded to a multiple; padding lanes re-render
    pixel 0 (sliced off after the gather)."""
    n = camera.num_pixels
    ids = torch.zeros(pad_to_multiple(n, multiple), dtype=torch.int64, device=device)
    ids[:n] = torch.arange(n, device=device)
    return ids


def _render_ids(scene: Scene, camera: Camera, key: torch.Tensor, sample_indices: Iterable[int],
                ids: torch.Tensor, differentiable: bool, row0: int = 0) -> torch.Tensor:
    """Sum of per-sample colors [len(ids), 3] of the pixel ids, which are
    rows row0.. of the whole id list: sample s draws from fold_in(key, s)
    (split into the camera and trace keys) at those rows."""
    tracer = trace_rays if differentiable else trace_rays_fast
    w = camera.image_width
    acc = torch.zeros(ids.shape[0], 3, dtype=torch.float32, device=ids.device)
    for s in sample_indices:
        k_cam, k_trace = prng.split(prng.fold_in(key, int(s)))
        o, d = generate_rays(camera, ids % w, ids // w, key=k_cam, row0=row0)
        acc = acc + tracer(scene, o, d, k_trace, camera.max_depth, row0=row0)
    return acc


def replicated_scene(scene: Scene, mesh: Mesh) -> Scene:
    """The scene replicated over the rays axis: its float fields' gradients
    are summed over the axis's ranks in the backward."""
    leaves = replicate([getattr(scene, k) for k in _DIFF], mesh, RAYS_AXIS)
    return scene.with_diff_params(dict(zip(_DIFF, leaves)))


class _ZeroRows(torch.autograd.Function):
    """Zero rows that depend on the scene's float fields (zero cotangents),
    for a shard with no real pixel: its backward still reaches the scene's
    replication and joins its collective."""

    @staticmethod
    def forward(ctx, rows, *fields):
        ctx.like = [(f.shape, f.dtype, f.device) for f in fields]
        return fields[0].new_zeros(rows, 3)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.like)


def _pad_rows(cols: torch.Tensor, s_loc: int) -> torch.Tensor:
    if cols.shape[0] == s_loc:
        return cols
    return torch.cat([cols, cols.new_zeros(s_loc - cols.shape[0], 3)])


class ShardedRenderer:
    """The scan engine (render/renderer.py's bounce, no kernel) on this
    rank's shard of the padded pixel ids; scene and camera replicated.
    The image is bit for bit the single-device `_render_ids` of the whole
    id list, whatever the mesh."""

    def __init__(self, mesh: Mesh, camera: Camera, differentiable: bool = False,
                 device=None):
        self.mesh = mesh
        self.dev = resolve_device(device)
        self.camera = camera.to(self.dev)
        self.differentiable = differentiable
        self.ids = _padded_pixel_ids(camera, mesh.n_rays, self.dev)
        self.s_loc = self.ids.shape[0] // mesh.n_rays

    def local(self, scene: Scene, key: torch.Tensor, sample_indices: Iterable[int],
              rank: int) -> torch.Tensor:
        """Color sums [s_loc, 3] of shard rank over the samples."""
        r0 = rank * self.s_loc
        return _render_ids(scene.to(self.dev), self.camera, key, sample_indices,
                           self.ids[r0:r0 + self.s_loc], self.differentiable, row0=r0)

    def render_sample_sum_padded(self, scene: Scene, key: torch.Tensor,
                                 sample_indices: Iterable[int]) -> torch.Tensor:
        """This rank's color sums [s_loc, 3] (gather_image joins them)."""
        return self.local(scene, key, sample_indices, self.mesh.rays_index)

    def render_sample_sum(self, scene: Scene, key: torch.Tensor,
                          sample_indices: Iterable[int]) -> torch.Tensor:
        """Color sums [num_pixels, 3] of the whole image, on every rank."""
        part = self.render_sample_sum_padded(scene, key, sample_indices)
        return gather_image(part, self.mesh)[:self.camera.num_pixels]

    def render_image(self, scene: Scene, seed: int = 0, spp: Optional[int] = None,
                     batch: int = 16) -> np.ndarray:
        spp = spp if spp is not None else self.camera.samples_per_pixel
        key = prng.PRNGKey(seed)
        acc = None
        for done in range(0, spp, batch):
            part = self.render_sample_sum(scene, key, range(done, min(done + batch, spp)))
            acc = part if acc is None else acc + part
        img = acc.cpu().numpy() / spp
        return img.reshape(self.camera.image_height, self.camera.image_width, 3)


def make_sharded_grad_fn(mesh: Mesh, camera: Camera, device=None):
    """grad_fn(scene, key, sample_indices, target [n_pix, 3]) -> (loss,
    grads): the masked mean squared error of the rendered image over the
    WHOLE image (each rank's squared error summed, divided by 3 * n_pix)
    and its gradients in the five float fields, summed over the rays axis
    so every rank holds them.  grad_fn.local(params, scene, key,
    sample_indices, target, rank) is shard rank's term of the loss,
    differentiable in params, with no collective."""
    dev = resolve_device(device)
    cam = camera.to(dev)
    n_pix = camera.num_pixels
    ids = _padded_pixel_ids(camera, mesh.n_rays, dev)
    m = ids.shape[0]
    s_loc = m // mesh.n_rays
    weight = (torch.arange(m, device=dev) < n_pix).to(torch.float32)

    def _target(target) -> torch.Tensor:
        tgt = torch.zeros(m, 3, dtype=torch.float32, device=dev)
        tgt[:n_pix] = torch.as_tensor(target, dtype=torch.float32).reshape(-1, 3).to(dev)
        return tgt

    def local(params: Dict[str, torch.Tensor], scene: Scene, key, sample_indices, target,
              rank: int) -> torch.Tensor:
        samples = list(sample_indices)
        s = scene.to(dev).with_diff_params(params)
        r0 = rank * s_loc
        total = _render_ids(s, cam, key, samples, ids[r0:r0 + s_loc], True, row0=r0)
        img = total / len(samples)
        se = torch.sum((img - _target(target)[r0:r0 + s_loc]) ** 2, dim=-1)
        return torch.sum(se * weight[r0:r0 + s_loc]) / (3.0 * n_pix)

    def grad_fn(scene: Scene, key, sample_indices, target):
        leaves = {k: getattr(scene, k).detach().to(dev).requires_grad_() for k in _DIFF}
        rep = dict(zip(_DIFF, replicate(list(leaves.values()), mesh, RAYS_AXIS)))
        loss = local(rep, scene, key, sample_indices, target, mesh.rays_index)
        loss.backward()
        return axis_sum(loss.detach(), mesh, RAYS_AXIS), {k: v.grad for k, v in leaves.items()}

    grad_fn.local = local
    return grad_fn


def _rank_fn(local, mesh: Mesh, dev):
    """The factory's function for this rank: local on the rank's shard of
    the replicated scene."""
    def run(scene: Scene, *args):
        return local(replicated_scene(scene.to(dev), mesh), *args, rank=mesh.rays_index)

    run.local = local
    return run


def make_tape_dp_tracer(mesh: Mesh, key: torch.Tensor, max_depth: int, pool: int = 4096,
                        intersect_fn=None, use_fused: bool = False, budget=None,
                        refill_every: int = 1, use_mega: bool = False,
                        mega_bwd: bool = False, ray_grads: bool = True, device=None):
    """The tape tracer of given rays (grad/tapegrad.py::make_tape_tracer,
    every mode) on this rank's shard of the rays: f(scene, ray_o [R, 3],
    ray_d [R, 3]) -> colors [R / n_rays, 3] of rows rank * R / n_rays ..,
    differentiable in the scene (summed over the rays axis) and in the
    rays (in this rank's rows).  Shard i draws as a single-device run of
    the tracer on its rays with fold_in(key, i).  R must divide by
    n_rays.  f.local(scene, ray_o, ray_d, rank)."""
    from distributed_raytracer_tpu_torch.grad.tapegrad import make_tape_tracer
    from distributed_raytracer_tpu_torch.ops.intersect import closest_hit

    dev = resolve_device(device)
    tracer = make_tape_tracer(key, max_depth, pool=pool, intersect_fn=intersect_fn or closest_hit,
                              use_fused=use_fused, budget=budget, refill_every=refill_every,
                              use_mega=use_mega, ray_grads=ray_grads, mega_bwd=mega_bwd,
                              device=dev)

    def local(scene: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor, rank: int):
        r = ray_o.shape[0]
        if r % mesh.n_rays:
            raise ValueError(f"{r} rays do not split over {mesh.n_rays} ranks")
        s = r // mesh.n_rays
        return tracer(scene, ray_o[rank * s:(rank + 1) * s], ray_d[rank * s:(rank + 1) * s],
                      prng.fold_in(key, rank))

    return _rank_fn(local, mesh, dev)


def _camera_dp(tracer, mesh: Mesh, camera: Camera, dev, ids_for):
    n_pix = camera.num_pixels
    s_loc = shard_size(n_pix, mesh.n_rays)

    def local(scene: Scene, rank: int) -> torch.Tensor:
        pix0, n_valid = shard_span(n_pix, s_loc, rank)
        if n_valid == 0:  # a shard past the image: zero rows, no launch
            return _ZeroRows.apply(s_loc, *(getattr(scene, k) for k in _DIFF))
        return _pad_rows(tracer(scene, ids_for(pix0, n_valid), pix0=pix0), s_loc)

    return _rank_fn(local, mesh, dev)


def make_tape_camera_dp_tracer(mesh: Mesh, camera: Camera, bounce_seed: int, cam_seed: int,
                               device=None):
    """The camera tape tracer (K6 recording forward, K8 reverse walk) on
    this rank's contiguous pixel shard: f(scene) -> colors [s_loc, 3] of
    pixels rank * s_loc .., differentiable in the scene; rows past the
    image are zero (a shard with no real pixel launches nothing).  Every
    draw is keyed by the global (pixel, depth) hash, so the shards'
    colors are the single-device tracer's bit for bit and the scene
    gradients differ only in summation order.  f.local(scene, rank)."""
    from distributed_raytracer_tpu_torch.grad.tapegrad import make_tape_camera_tracer

    dev = resolve_device(device)
    tracer = make_tape_camera_tracer(camera, bounce_seed, cam_seed, iota_pix=True, device=dev)
    # iota_pix: the kernel reads only the count of pixel_ids
    return _camera_dp(tracer, mesh, camera, dev,
                      lambda pix0, n: torch.zeros(n, dtype=torch.int32))


def make_tape_camera_walk_dp_tracer(mesh: Mesh, camera: Camera, bounce_seed: int,
                                    cam_seed: int, scene0: Scene, chunk: int = 256,
                                    bound_slack: float = 0.0, device=None):
    """make_tape_camera_dp_tracer's sibling past 512 spheres: the walk tape
    tracer (K9 record, K8) on this rank's pixel shard, the pack's skeleton
    built once from scene0.  Colors bit for bit the single-device walk
    tracer's; rows past the image are zero.  f.local(scene, rank)."""
    from distributed_raytracer_tpu_torch.grad.tapegrad import make_tape_camera_walk_tracer

    dev = resolve_device(device)
    tracer = make_tape_camera_walk_tracer(camera, bounce_seed, cam_seed, scene0, chunk=chunk,
                                          bound_slack=bound_slack, device=dev)
    return _camera_dp(tracer, mesh, camera, dev,
                      lambda pix0, n: torch.arange(pix0, pix0 + n, dtype=torch.int64))


def _sample_sums(launch, samples, s_loc: int, n_valid: int, dev, acc):
    """acc + each sample's colors, added in sample order (so batches of
    absolute sample indices accumulate to the same bits however the
    samples are split)."""
    for s in samples:
        colors = (launch(int(s)) if n_valid > 0 else
                  torch.zeros(s_loc, 3, dtype=torch.float32, device=dev))
        acc = colors if acc is None else acc + colors
    if acc is None:
        acc = torch.zeros(s_loc, 3, dtype=torch.float32, device=dev)
    return acc


def make_mega_dp_render(mesh: Mesh, camera: Camera, device=None):
    """The forward render kernel (K5) on this rank's pixel shard, one
    launch per sample at the shard's pix0, n_valid, n_cap = s_loc and the
    image's n_global: f(scene, bounce_seed, cam_seed, sample_indices,
    acc=None) -> acc + color sums [s_loc, 3], rows past the image zero.
    Draws are keyed by the global (ray id, depth) hash, so the shards are
    the single-device render_wavefront_sum_mega sum bit for bit whatever
    the mesh, and batches of absolute sample indices accumulated through
    acc give the same bits however the samples are split.
    f.local(scene, bounce_seed, cam_seed, sample_indices, rank, acc=None)."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk

    dev = resolve_device(device)
    n_pix = camera.num_pixels
    s_loc = shard_size(n_pix, mesh.n_rays)

    def local(scene: Scene, bounce_seed: int, cam_seed: int, sample_indices, rank: int,
              acc: Optional[torch.Tensor] = None) -> torch.Tensor:
        pix0, n_valid = shard_span(n_pix, s_loc, rank)
        cols, attrs, cam_row = mrk.prepare(scene, camera, dev)

        def launch(s):
            return mrk.mega_render_sample(
                cols, attrs, cam_row, bounce_seed=bounce_seed, cam_seed=cam_seed,
                rid_base=(s * n_pix) & _MASK32, pix0=pix0, n_valid=n_valid, n_cap=s_loc,
                w=camera.image_width, max_depth=camera.max_depth)[0]

        return _sample_sums(launch, sample_indices, s_loc, n_valid, dev, acc)

    def run(scene, bounce_seed, cam_seed, sample_indices, acc=None):
        return local(scene, bounce_seed, cam_seed, sample_indices, mesh.rays_index, acc)

    run.local = local
    return run


def make_mega_walk_dp_render(mesh: Mesh, pack, camera: Camera, device=None):
    """The walk render (K9) on this rank's pixel shard, past 512 spheres;
    pack: mega_walk_kernel.WalkPack.  f(bounce_seed, cam_seed,
    sample_indices, acc=None) -> acc + color sums [s_loc, 3], with
    make_mega_dp_render's contract (bit for bit the single-device walk
    render).  f.local(bounce_seed, cam_seed, sample_indices, rank,
    acc=None)."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk

    dev = resolve_device(device)
    n_pix = camera.num_pixels
    s_loc = shard_size(n_pix, mesh.n_rays)
    args = mwk._pack_args(pack, camera, dev)

    def local(bounce_seed: int, cam_seed: int, sample_indices, rank: int,
              acc: Optional[torch.Tensor] = None) -> torch.Tensor:
        pix0, n_valid = shard_span(n_pix, s_loc, rank)

        def launch(s):
            return mwk.mega_walk_sample(
                *args, bounce_seed=bounce_seed, cam_seed=cam_seed,
                rid_base=(s * n_pix) & _MASK32, pix0=pix0, n_valid=n_valid, n_cap=s_loc,
                w=camera.image_width, max_depth=camera.max_depth)[0]

        return _sample_sums(launch, sample_indices, s_loc, n_valid, dev, acc)

    def run(bounce_seed, cam_seed, sample_indices, acc=None):
        return local(bounce_seed, cam_seed, sample_indices, mesh.rays_index, acc)

    run.local = local
    return run


def make_fused_dp_render(mesh: Mesh, camera: Camera, pool_size: int = 16384, culled=None,
                         device=None):
    """The fused wavefront engine (render/wavefront.py::
    render_wavefront_sum_fused: K10, or K14 over a CulledScene, whose
    .scene is then the scene to pass) on this rank's contiguous pixel-id
    shard, padding ids re-rendering pixel 0: f(scene, key, spp) -> color
    sums [s_loc, 3].  Shard i draws with the seeds of fold_in(key, i), so
    it equals a single-device run on its ids at those seeds.
    f.local(scene, key, spp, rank)."""
    from distributed_raytracer_tpu_torch.render.wavefront import render_wavefront_sum_fused

    dev = resolve_device(device)
    ids = _padded_pixel_ids(camera, mesh.n_rays, dev)
    s_loc = ids.shape[0] // mesh.n_rays

    def local(scene: Scene, key: torch.Tensor, spp: int, rank: int) -> torch.Tensor:
        bs, cs = prng.seed_pair(prng.fold_in(key, rank))
        return render_wavefront_sum_fused(
            scene, camera, spp, bs, cs, pool_size=min(pool_size, s_loc * spp),
            pixel_ids=ids[rank * s_loc:(rank + 1) * s_loc], culled=culled, device=dev)

    def run(scene, key, spp):
        return local(scene, key, spp, mesh.rays_index)

    run.local = local
    return run
