"""The forward render: one whole image sample per kernel launch.

Port of distributed_raytracer_tpu/ops/pallas/mega_render_kernel.py.  On a
CUDA tensor `mega_render_sample` launches the hand-written kernel
csrc/mega_render.cu; on a CPU tensor it runs `mega_render_plain`, the same
arithmetic in plain PyTorch.  Every draw is the (rid, depth)-keyed hash:

- camera draws: hash_u01(rid, cam_seed, 8..11);
- bounce draws: hash_u01(rid, bounce_seed + depth * 65537, 0..4);
- rid = sample * n_global + pix0 + local pixel index (int32 wrap).

So an image is a pure function of (scene, camera, seeds), bit for bit
whatever the launch shape or pixel sharding, and comparable pixel by
pixel with the JAX kernel.  The TPU kernel's scheduling arguments (pool,
budget, block_rays) and its truncation fallback have no counterpart: the
CUDA kernel runs every ray to its end.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import (  # noqa: F401  (camera_scalar_row: re-export)
    CAM_ROW,
    Camera,
    camera_scalar_row,
    rays_from_row,
)
from distributed_raytracer_tpu_torch.ops.kernels import _build
from distributed_raytracer_tpu_torch.ops.kernels.bounce import (
    A_ROWS,
    scene_sweep_arrays,
    shade_vals,
    sweep_winner,
)
from distributed_raytracer_tpu_torch.ops.kernels.hash import hash_u01, wrap_i32

CAM_D0 = 8          # camera draws use d = 8..11
MAX_SPHERES = 512   # the scene must fit the kernel's shared memory
_MASK32 = 0xFFFFFFFF
# ray x sphere elements per [R, N] sweep in the plain version (64 MB
# temporaries: 32,768 rays at N = 512)
_PLAIN_ELEMS = 32768 * 512


def camera_ray_rows(cam_row: torch.Tensor, pix: torch.Tensor, rid: torch.Tensor,
                    cam_seed: int, w: int):
    """Primary rays (ox, oy, oz, dx, dy, dz) for pixel ids pix with ray
    ids rid, both int64 [R]: the plain version of camera_ray_rows
    (mega_render_kernel.py:92) and of csrc/camera.cuh."""
    draws = tuple(hash_u01(rid, cam_seed, CAM_D0 + k) for k in range(4))
    j = pix // w
    return rays_from_row(cam_row, pix - j * w, j, draws)


def camera_rays_host(cam_row: torch.Tensor, pix: torch.Tensor, rid: torch.Tensor,
                     cam_seed: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [R, 3], d [R, 3]): the primary rays of pixels pix with ray ids
    rid, bit for bit the rays the kernels make in place (csrc/camera.cuh),
    as differentiable functions of the [24] camera row: the port of
    camera_rays_host (mega_render_kernel.py:140).  torch.autograd of it
    maps primary-ray cotangents to cam_row cotangents (the pose tracer's
    backward), and on to the pose when cam_row was derived from it."""
    ox, oy, oz, dx, dy, dz = camera_ray_rows(cam_row, pix.to(torch.int64),
                                             rid.to(torch.int64) & _MASK32, cam_seed, w)
    return torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1)


def mega_render_plain(cols, attrs, cam_row, *, bounce_seed: int, cam_seed: int,
                      rid_base: int, pix0: int, n_valid: int, n_cap: int, w: int,
                      max_depth: int, sweep: Optional[Callable] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on any device: a dense trace of
    the live rays, depth by depth, the [R, N] sweep taken _PLAIN_ELEMS / N
    rays at a time (sweep: trace_plain's).  Returns (colors [n_cap, 3] f32,
    bounces [1] int64: the number of (ray, bounce) sweeps run)."""
    dev = cols.device
    pix = pix0 + torch.arange(n_valid, dtype=torch.int64, device=dev)
    rid = (rid_base + pix) & _MASK32
    colors = torch.zeros(n_cap, 3, dtype=torch.float32, device=dev)
    o, d = camera_rays_host(cam_row, pix, rid, cam_seed, w)
    bounces = trace_plain(cols, attrs, o, d, rid, bounce_seed=bounce_seed, max_depth=max_depth,
                          colors=colors, sweep=sweep)
    return colors, torch.tensor([bounces], dtype=torch.int64, device=dev)


def trace_plain(cols, attrs, o, d, rid, *, bounce_seed: int, max_depth: int,
                colors: torch.Tensor, record: Optional[Callable] = None,
                sweep: Optional[Callable] = None) -> int:
    """The plain trace of rays 0..R-1 from their primary rays o, d [R, 3]
    (the camera's, or a ray table's; not modified) with ray ids rid (int64
    [R], keying the bounce draws), shared by the render and the recording
    forward, dense and walk.  Writes each finished ray's color into
    colors[:R]; when given, record(depth, rays, o, d, atten, shade, t,
    winner, fin) is called with every chunk of live rays, their
    pre-bounce state and what the bounce computed.  sweep(ox, oy, oz, dx,
    dy, dz, a, inv_a) -> (t, winner) replaces the dense sweep_winner over
    (cols, attrs).  Returns the number of (ray, bounce) sweeps run."""
    dev = cols.device
    o, d = o.detach().clone(), d.detach().clone()
    atten = torch.ones_like(o)
    alive = torch.arange(rid.numel(), dtype=torch.int64, device=dev)
    step = max(1, _PLAIN_ELEMS // cols.shape[1])
    if sweep is None:
        def sweep(*ray):
            return sweep_winner(*ray, cols, attrs)
    bounces = 0
    for depth in range(max_depth):
        if alive.numel() == 0:
            break
        bounces += alive.numel()
        seed = wrap_i32(bounce_seed + depth * 65537)
        still = []
        for c0 in range(0, alive.numel(), step):
            idx = alive[c0:c0 + step]
            ro, rd = o[idx], d[idx]
            rx, ry, rz = ro.unbind(-1)
            qx, qy, qz = rd.unbind(-1)
            a = qx * qx + qy * qy + qz * qz
            t, win = sweep(rx, ry, rz, qx, qy, qz, a, 1.0 / a)
            act = torch.ones_like(t, dtype=torch.bool)
            draws = tuple(hash_u01(rid[idx], seed, k) for k in range(5))
            v = shade_vals(rx, ry, rz, qx, qy, qz, a, act, t, win, draws)
            fin = v[12] > 0
            at = atten[idx]
            if record is not None:
                record(depth, idx, ro, rd, at, v, t, win, fin)
            done = idx[fin]
            colors[done] = at[fin] * torch.stack(v[9:12], -1)[fin]
            o[idx] = torch.stack(v[0:3], -1)
            d[idx] = torch.stack(v[3:6], -1)
            atten[idx] = at * torch.stack(v[6:9], -1)
            still.append(idx[~fin])
        alive = torch.cat(still)
    # rays still alive after max_depth bounces contribute black
    return bounces


def _argtypes(fn):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, i, ctypes.c_uint, i, i, i, i, i, p, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def check_sweep_args(cols, attrs, cam_row) -> int:
    """Check the scene and camera operands a kernel reads (CUDA float32,
    contiguous, [4, n], [11, n] and [24] unless cam_row is None, n <=
    MAX_SPHERES); returns n."""
    n = cols.shape[1]
    operands = [("cols", cols, (4, n)), ("attrs", attrs, (A_ROWS, n))]
    if cam_row is not None:
        operands.append(("cam_row", cam_row, (CAM_ROW,)))
    for name, x, shape in operands:
        if x.device.type != "cuda" or x.dtype != torch.float32:
            raise ValueError(f"{name} must be a CUDA float32 tensor")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}, got {tuple(x.shape)}")
    if not 1 <= n <= MAX_SPHERES:
        raise NotImplementedError(_too_many(n))
    return n


def mega_render_cuda(cols, attrs, cam_row, *, bounce_seed: int, cam_seed: int,
                     rid_base: int, pix0: int, n_valid: int, n_cap: int, w: int,
                     max_depth: int, grid: Optional[int] = None,
                     with_warp_steps: bool = False):
    """Launch csrc/mega_render.cu on the current stream (no sync).  Same
    arguments and results as mega_render_plain; the bounce count is
    summed by the kernel.  grid: the most blocks of the persistent kernel
    (by default as many as fit the card at once; 1 makes one block trace
    every ray).  with_warp_steps: also return the [1] int64 count of
    (warp, step) pairs that swept, for lane_use."""
    n = check_sweep_args(cols, attrs, cam_row)
    if not 0 <= n_valid <= n_cap:
        raise ValueError(f"need 0 <= n_valid <= n_cap, got {n_valid}, {n_cap}")
    dev = cols.device
    grid = grid or _build.occupancy_grid("mega_render", "mega_render_blocks_per_sm", dev)
    colors = torch.empty(n_cap, 3, dtype=torch.float32, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)  # bounces, warp steps, next ray
    fn = _argtypes(_build.load("mega_render").mega_render_launch)
    err = fn(cols.data_ptr(), attrs.data_ptr(), n, cam_row.data_ptr(),
             wrap_i32(bounce_seed), wrap_i32(cam_seed), rid_base & _MASK32,
             pix0, n_valid, n_cap, w, max_depth, colors.data_ptr(),
             counts.data_ptr(), grid, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mega_render_launch")
    mega_render_cuda.launches += 1
    if with_warp_steps:
        return colors, counts[0:1], counts[1:2]
    return colors, counts[0:1]


mega_render_cuda.launches = 0


def mega_render_sample(cols, attrs, cam_row, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image sample: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if cols.device.type == "cpu":
        return mega_render_plain(cols, attrs, cam_row, **kw)
    return mega_render_cuda(cols, attrs, cam_row, **kw)


def mega_render_supported(scene: Scene) -> bool:
    """True when the scene fits one kernel sweep (N <= 512)."""
    return scene.num_spheres <= MAX_SPHERES


def _too_many(n: int) -> str:
    return (f"scene has {n} spheres; the mega render kernel sweeps at most "
            f"{MAX_SPHERES}. Larger scenes take the walk engine "
            f"(ops/kernels/mega_walk_kernel.py; render_progressive routes to it)")


def prepare(scene: Scene, camera: Camera, device=None):
    """(cols, attrs, cam_row) on the resolved device, for
    mega_render_sample."""
    dev = resolve_device(device)
    if not mega_render_supported(scene):
        raise NotImplementedError(_too_many(scene.num_spheres))
    cols, attrs = scene_sweep_arrays(scene.to(dev))
    return cols, attrs, camera_scalar_row(camera).to(dev).contiguous()


def mega_render_colors(scene: Scene, camera: Camera, sample: int, bounce_seed: int,
                       cam_seed: int, *, n_cap: int = 0, pix0: int = 0,
                       n_valid: Optional[int] = None, n_global: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """Per-pixel colors [n_cap, 3] of one image sample.  n_cap=0 means
    the whole image.  A shard passes its capacity n_cap, its first global
    pixel pix0, its real pixel count n_valid and the image's n_global;
    its draws stay keyed by global ray id, so shards concatenate to the
    whole image bit for bit."""
    n_cap = n_cap or camera.num_pixels
    n_valid = n_cap if n_valid is None else n_valid
    n_global = n_cap if n_global is None else n_global
    cols, attrs, cam_row = prepare(scene, camera, device)
    colors, _ = mega_render_sample(
        cols, attrs, cam_row, bounce_seed=bounce_seed, cam_seed=cam_seed,
        rid_base=(sample * n_global) & _MASK32, pix0=pix0, n_valid=n_valid,
        n_cap=n_cap, w=camera.image_width, max_depth=camera.max_depth)
    return colors


def render_wavefront_sum_mega(scene: Scene, camera: Camera, spp: int, bounce_seed: int,
                              cam_seed: int, device=None) -> torch.Tensor:
    """Color sum [n_pix, 3] over samples 0..spp-1, one kernel launch per
    sample, summed in sample order."""
    cols, attrs, cam_row = prepare(scene, camera, device)
    n = camera.num_pixels
    acc = None
    for s in range(spp):
        colors, _ = mega_render_sample(
            cols, attrs, cam_row, bounce_seed=bounce_seed, cam_seed=cam_seed,
            rid_base=(s * n) & _MASK32, pix0=0, n_valid=n, n_cap=n,
            w=camera.image_width, max_depth=camera.max_depth)
        acc = colors if acc is None else acc + colors
    return acc
