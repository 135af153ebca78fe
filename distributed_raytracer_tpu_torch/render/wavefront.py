"""The wavefront engines: a persistent pool of ray lanes, kept full from
the global ray stream.

Port of distributed_raytracer_tpu/render/wavefront.py: the reference
engine render_wavefront_sum (:78) with render_image_wavefront (:533),
the fused engine render_wavefront_sum_fused (:243-495) and
warp_resort_permutation (:513-530).

The reference engine is JAX's loop of ops/trace.py's bounce_step over the
pool, on JAX's threefry keys, so its sums equal JAX's to rounding.  Per
iteration `it` (one block of refill_every bounces, 1 by default): k =
fold_in(key, it) splits into k_cam and k_bounce; free lanes take the next
stream rays (cumsum rank; camera rays drawn for the whole pool from
k_cam); bounce s of the block draws from fold_in(k_bounce, s) through
intersect_fn (the dense closest_hit, K11's closest_hit_pallas, or a
culled intersect, K12/K13); a lane that finished writes its color once
per block into a per-ray buffer at its ray index (a unique-index scatter
into total + 1 rows, the last one dropped); a lane still alive at the
camera's depth is black.  resort_every re-sorts the lanes as the fused
engine does; the draws are per lane position, so a re-sort changes the
noise, as in JAX.  The loop reads the live count back once per block.

The fused engine, per block of REFILL_EVERY bounces:

  1. refill: free lanes take the next stream rays by cumsum rank (ray
     index = emitted + rank, pixel = ray index mod the pixel count, through
     pixel_ids or pixel_perm), camera rays from camera_rays_host with the
     draws hash_u01(ray index, cam_seed, 8..11);
  2. bounces: one fused bounce of the whole pool each (K10, or K14 with a
     CulledScene), seed bounce_seed + iteration * 65537, the lane's ray
     index keying the draws; depth counts the live lanes' bounces, and a
     lane still alive at max_depth is exhausted (black);
  3. drain: a lane finishes at most once per block; its color (the
     attenuation so far times the terminal color) is stored once per block
     into a per-ray buffer at its ray index (unique indices), which is
     summed over the samples at the end.

The loop runs until the stream is emitted and no lane is live; it reads
the live count back to the host once per block.  The JAX engine's draws
are kept bit for bit on the culled path (K14's and the camera's hash
keys); the dense path is keyed the same way (ops/kernels/bounce_kernel.py
says why), so with a pool that holds every ray (all rays enter at
iteration 0, so the iteration is each ray's depth) the engine's sums equal
render_wavefront_sum_mega's at the same two seeds, and the dense and
culled engines give equal sums at equal scene content.

Dropped as TPU scheduling: block_rays, sphere_chunk (and _auto_chunk,
DRAY_FORCE_CHUNK), the pos-gather drain with pos_drain_fits,
fused_drain_rows and POSDRAIN_HBM_CAP (the drain is one scatter per
block, and nothing can overflow).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import Camera, camera_scalar_row, generate_rays
from distributed_raytracer_tpu_torch.ops.intersect import closest_hit
from distributed_raytracer_tpu_torch.ops.kernels.bounce_kernel import (
    fused_bounce,
    fused_scene_arrays,
)
from distributed_raytracer_tpu_torch.ops.kernels.culled_bounce_kernel import (
    build_culled_pack,
    culled_fused_bounce,
)
from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import CulledScene
from distributed_raytracer_tpu_torch.ops.kernels.hash import wrap_i32
from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import closest_hit_pallas
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import camera_rays_host
from distributed_raytracer_tpu_torch.ops.trace import RayState, bounce_step
from distributed_raytracer_tpu_torch.render.order import inverse_permutation, tile_permutation

# lanes in the pool: the JAX engine's default (wavefront.py:53)
DEFAULT_POOL = 16384
# bounces per refill block of the fused engine: the JAX engine's default
# (refill_every=2); the reference engine's default is 1
REFILL_EVERY = 2


def scene_box(scene: Scene):
    """(lo [3], hi [3]) of the scene's real spheres and the origin (the
    re-sort's Morton grid; radius <= 0 counts as a point at 0)."""
    real = scene.radii > 0.0
    safe_c = torch.where(real[:, None], scene.centers, 0.0)
    safe_r = torch.where(real, scene.radii, 0.0)[:, None]
    return (safe_c - safe_r).amin(0), (safe_c + safe_r).amax(0)


def render_wavefront_sum(scene: Scene, camera: Camera, key: torch.Tensor, spp: int,
                         pool_size: int = DEFAULT_POOL, intersect_fn=closest_hit,
                         pixel_perm=None, resort_every: int = 0,
                         refill_every: int = 1) -> torch.Tensor:
    """Color sum [n_pix, 3] of spp samples per pixel on the reference
    engine, on the scene's device (scene and camera on one device).
    pixel_perm: [n_pix] stream pixel order (render/order.py's
    tile_permutation); the sums come back in pixel order either way.  The
    ray state takes the scene's dtype (float32; the plain versions also
    float64, whose run referees float32 rounding in tests)."""
    dev = scene.centers.device
    n_pix = camera.num_pixels
    w = camera.image_width
    total = n_pix * spp
    b = min(pool_size, total)
    max_depth = camera.max_depth
    k_sub = max(1, refill_every)
    perm = None if pixel_perm is None else torch.as_tensor(pixel_perm).to(dev, torch.int64)
    if resort_every:
        bb_lo, bb_hi = scene_box(scene)

    f = dict(dtype=scene.centers.dtype, device=dev)
    st = RayState(origin=torch.zeros(b, 3, **f), direction=torch.zeros(b, 3, **f),
                  attenuation=torch.ones(b, 3, **f), color=torch.zeros(b, 3, **f),
                  active=torch.zeros(b, dtype=torch.bool, device=dev))
    lane_ray = torch.zeros(b, dtype=torch.int64, device=dev)
    depth = torch.zeros(b, dtype=torch.int32, device=dev)
    out = torch.zeros(total + 1, 3, **f)  # per ray, in stream order; row total: dropped
    emitted, n_live, it = 0, 0, 0
    while emitted < total or n_live > 0:
        k_cam, k_bounce = prng.split(prng.fold_in(key, it))
        if resort_every and it > 0 and it % resort_every < k_sub:
            order = warp_resort_permutation(st.origin, st.direction, st.active, bb_lo, bb_hi)
            st = RayState(*(x[order] for x in st))
            lane_ray, depth = lane_ray[order], depth[order]
        if emitted < total:  # refill; with nothing left to emit it takes no lane
            free = ~st.active
            rank = torch.cumsum(free, 0, dtype=torch.int64) - 1
            take = free & (rank < total - emitted)
            ray_idx = emitted + torch.where(take, rank, 0)
            pix = ray_idx % n_pix
            if perm is not None:
                pix = perm[pix]
            new_o, new_d = generate_rays(camera, pix % w, pix // w, key=k_cam)
            tk = take[:, None]
            st = RayState(origin=torch.where(tk, new_o, st.origin),
                          direction=torch.where(tk, new_d, st.direction),
                          attenuation=torch.where(tk, 1.0, st.attenuation),
                          color=torch.where(tk, 0.0, st.color), active=st.active | take)
            lane_ray = torch.where(take, ray_idx, lane_ray)
            depth = torch.where(take, 0, depth)
            emitted += min(b - n_live, total - emitted)
        fin_any = torch.zeros(b, dtype=torch.bool, device=dev)
        fin_color = torch.zeros(b, 3, **f)
        for s in range(k_sub):
            was_active = st.active
            st2 = bounce_step(st, prng.fold_in(k_bounce, s), scene, intersect_fn)
            depth = depth + was_active.to(torch.int32)
            finished = was_active & ~st2.active  # wrote its color this bounce
            exhausted = st2.active & (depth >= max_depth)  # out of depth: black
            fin_color = torch.where(finished[:, None], st2.color, fin_color)
            fin_any = fin_any | finished
            st = st2._replace(active=st2.active & ~exhausted)
        # a lane finishes at most one ray per block, so every index but the dropped row is unique
        out[torch.where(fin_any, lane_ray, total)] = fin_color
        it += k_sub
        n_live = int(st.active.sum())
    per_ray = out[:total].view(spp, n_pix, 3)
    sums = per_ray[0]
    for s in range(1, spp):
        sums = sums + per_ray[s]
    if perm is not None:  # stream order -> pixel order
        sums = sums[torch.as_tensor(inverse_permutation(perm.cpu().numpy()), device=dev)]
    return sums.clone()


def render_image_wavefront(scene: Scene, camera: Camera, seed: int = 0,
                           spp: Optional[int] = None, batch: int = 32,
                           pool_size: int = DEFAULT_POOL, use_pallas: bool = False,
                           intersect_fn=None, progress_cb=None, ray_order: str = "row",
                           resort_every: int = 0, refill_every: int = 1,
                           device=None) -> np.ndarray:
    """A full image on the reference engine, the linear mean [H, W, 3] f32
    on the host: PRNGKey(seed), batch b starting at sample `done` keyed
    fold_in(key, done).  use_pallas traces with K11 (closest_hit_pallas);
    intersect_fn, e.g. make_culled_intersect(culled) over culled.scene,
    overrides it.  ray_order "tiled" streams the pixels in 32x16 tiles."""
    spp = spp if spp is not None else camera.samples_per_pixel
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    if intersect_fn is None:
        intersect_fn = closest_hit_pallas if use_pallas else closest_hit
    perm = tile_permutation(camera.image_width, camera.image_height) \
        if ray_order == "tiled" else None
    key = prng.PRNGKey(seed)
    acc = torch.zeros(camera.num_pixels, 3, dtype=torch.float32, device=dev)
    done = 0
    while done < spp:
        n = min(batch, spp - done)
        acc = acc + render_wavefront_sum(scene, camera, prng.fold_in(key, done), n, pool_size,
                                         intersect_fn, perm, resort_every, refill_every)
        done += n
        if progress_cb is not None:
            progress_cb(done, acc.cpu().numpy() / done)
    img = acc.cpu().numpy() / spp
    return img.reshape(camera.image_height, camera.image_width, 3)


def render_wavefront_sum_fused(
    scene: Scene,
    camera: Camera,
    spp: int,
    bounce_seed: int,
    cam_seed: int,
    *,
    pool_size: int = DEFAULT_POOL,
    pixel_ids=None,
    culled: Optional[CulledScene] = None,
    resort_every: int = 0,
    pixel_perm=None,
    device=None,
) -> torch.Tensor:
    """Color sum [n_pix, 3] of spp samples per pixel on the fused engine.

    pixel_ids: [K] pixel ids to render instead of the whole image; sums
    come back in the order of the ids.  pixel_perm: [n_pix] stream pixel
    order (render/order.py's tile_permutation); sums come back in pixel
    order.  The two exclude each other.  culled: a CulledScene; the engine
    then traces culled.scene (pass the scene it was built from as scene)
    with the culled fused bounce (K14), and its idx is an index into
    culled.scene.  resort_every: culled only (ValueError otherwise, as in
    the JAX engine): at the start of each block whose window crosses a
    multiple of it, the lanes are re-sorted by (origin Morton cell,
    direction octant); every draw is keyed by ray index, so the sums do not
    change.  The ray state takes the traced scene's dtype
    (the kernels take float32; the plain versions also float64, whose run
    referees f32 rounding in tests).  Runs on the card unless device says
    otherwise."""
    if pixel_ids is not None and pixel_perm is not None:
        raise ValueError("pixel_ids and pixel_perm exclude each other")
    if resort_every and culled is None:
        raise ValueError("resort_every on the fused engine requires culled (the JAX engine's "
                         "dense fused kernel draws by lane, so it refuses a re-sort)")
    if spp < 1:
        raise ValueError(f"need spp >= 1, got {spp}")
    dev = resolve_device(device)

    def ids_on_dev(x):
        return None if x is None else torch.as_tensor(x).to(dev, torch.int64)

    pid, perm = ids_on_dev(pixel_ids), ids_on_dev(pixel_perm)
    n_pix = pid.shape[0] if pid is not None else camera.num_pixels
    w = camera.image_width
    total = n_pix * spp
    b = min(pool_size, total)
    max_depth = camera.max_depth
    cam_row = camera_scalar_row(camera).to(dev)

    if culled is not None:
        pack = build_culled_pack(culled).to(dev)

        def bounce(o, d, live, lane_ray, seed):
            return culled_fused_bounce(o, d, live, lane_ray, pack, seed)

        if resort_every:
            bb_lo, bb_hi = (x.to(dev) for x in scene_box(culled.scene))
    else:
        arrays = fused_scene_arrays(scene.to(dev))

        def bounce(o, d, live, lane_ray, seed):
            return fused_bounce(o, d, live, lane_ray, arrays, seed)

    fdt = dict(dtype=(culled.scene if culled is not None else scene).centers.dtype, device=dev)
    o = torch.zeros(b, 3, **fdt)
    d = torch.ones(b, 3, **fdt)  # a dead lane keeps a nonzero direction
    atten = torch.ones(b, 3, **fdt)
    lane_ray = torch.zeros(b, dtype=torch.int32, device=dev)
    depth = torch.zeros(b, dtype=torch.int32, device=dev)
    live = torch.zeros(b, dtype=torch.bool, device=dev)
    out = torch.zeros(total + 1, 3, **fdt)  # per ray, in stream order; row total: dropped
    emitted, n_live, it = 0, 0, 0
    while emitted < total or n_live > 0:
        if resort_every and it > 0 and it % resort_every < REFILL_EVERY:
            order = warp_resort_permutation(o, d, live, bb_lo, bb_hi)
            o, d, atten, lane_ray, depth, live = (
                x[order] for x in (o, d, atten, lane_ray, depth, live))
        if emitted < total:  # refill, once per block
            free = ~live
            rank = torch.cumsum(free, 0, dtype=torch.int64) - 1
            take = free & (rank < total - emitted)
            ray_idx = emitted + torch.where(take, rank, 0)
            pix = ray_idx % n_pix
            if pid is not None:
                pix = pid[pix]
            if perm is not None:
                pix = perm[pix]
            new_o, new_d = camera_rays_host(cam_row, pix, ray_idx, cam_seed, w)
            tk = take[:, None]
            o = torch.where(tk, new_o.to(o.dtype), o)
            d = torch.where(tk, new_d.to(d.dtype), d)
            atten = torch.where(tk, 1.0, atten)
            lane_ray = torch.where(take, ray_idx.to(torch.int32), lane_ray)
            depth = torch.where(take, 0, depth)
            live = live | take
            emitted += min(b - n_live, total - emitted)
        fin_any = torch.zeros(b, dtype=torch.bool, device=dev)
        fin_color = torch.zeros(b, 3, **fdt)
        for s in range(REFILL_EVERY):
            res = bounce(o, d, live, lane_ray, wrap_i32(bounce_seed + (it + s) * 65537))
            depth = depth + live.to(torch.int32)
            fin = (res.finished == 1) & live
            keep = live & ~fin
            exhausted = keep & (depth >= max_depth)
            fin_color = torch.where(fin[:, None], atten * res.color, fin_color)
            fin_any = fin_any | fin
            o, d = res.new_o, res.new_d
            atten = atten * res.atten  # 1 on every lane that did not scatter
            live = keep & ~exhausted
        # a lane finishes at most one ray per block, so every index but the dropped row is unique
        out[torch.where(fin_any, lane_ray.to(torch.int64), total)] = fin_color
        it += REFILL_EVERY
        n_live = int(live.sum())
    per_ray = out[:total].view(spp, n_pix, 3)
    sums = per_ray[0]
    for s in range(1, spp):  # in sample order, as render_wavefront_sum_mega sums
        sums = sums + per_ray[s]
    if perm is not None:  # stream order -> pixel order
        sums = sums[torch.as_tensor(inverse_permutation(perm.cpu().numpy()), device=dev)]
    return sums.clone()


def warp_resort_permutation(origin, direction, active, bb_lo, bb_hi) -> torch.Tensor:
    """[R] int64 lane order by (origin Morton cell in the 8^3 grid over
    [bb_lo, bb_hi], direction octant), inactive lanes last (wavefront.py:
    513-530; a stable sort)."""
    scale = 7.999 / torch.clamp_min(bb_hi - bb_lo, 1e-6)
    cell = ((origin - bb_lo) * scale).to(torch.int32).clamp(0, 7)

    def spread(v):
        return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4)

    morton = spread(cell[:, 0]) | (spread(cell[:, 1]) << 1) | (spread(cell[:, 2]) << 2)
    positive = (direction > 0).to(torch.int32)
    octant = positive[:, 0] | (positive[:, 1] << 1) | (positive[:, 2] << 2)
    key = torch.where(active, (morton << 3) | octant, 1 << 30)
    return torch.argsort(key, stable=True)
