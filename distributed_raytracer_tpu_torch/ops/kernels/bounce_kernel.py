"""One fused bounce of the wavefront engine's ray pool: closest hit and
shading of every lane in one launch (K10).

Port of distributed_raytracer_tpu/ops/pallas/bounce_kernel.py::
fused_bounce (:563; kernel _bounce_kernel :306).  On CUDA tensors
`fused_bounce` launches the hand-written kernel csrc/fused_bounce.cu; on
CPU tensors it runs `fused_bounce_plain`, the same arithmetic in plain
PyTorch (ops/kernels/bounce.py's sweep and shading).

Draws: the TPU kernel drew its five uniforms from the on-core generator
(`pltpu.prng_random_bits`, seeded per ray block), which has no
counterpart here (and gives zeros in interpret mode).  The port keys
them exactly as the culled fused bounce (K14) does: hash_u01(ray_id,
seed, d) for d = 0..4, with the wavefront engine passing each lane's
global ray id and seed = bounce_seed + iteration * 65537; and the dense
engine's camera rays are keyed like the culled engine's (hash_u01(ray
id, cam_seed, 8..11)) instead of the threefry camera key.  Both are
valid estimators of the same integral, as the JAX package states for its
own two generators; with the same keys the dense and culled engines give
the same image at equal scene content.  `draws=` hands in the five
uniforms instead (tests do).

The TPU kernel's scheduling arguments (block_rays, the sphere chunk of
its grid, DRAY_FORCE_CHUNK) have no counterpart: a group of threads per
lane sweeps the whole scene (csrc/trace.cuh group_sweep) and its first
thread shades, the shape read by `group_shape`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from distributed_raytracer_tpu_torch.core.vecmath import BIG
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.kernels import _build
from distributed_raytracer_tpu_torch.ops.kernels.bounce import (
    A_ROWS,
    scene_sweep_arrays,
    shade_vals,
    sweep_t,
    winner_of,
)
from distributed_raytracer_tpu_torch.ops.kernels.hash import hash_u01, wrap_i32
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import _PLAIN_ELEMS

# the launch counters, in the order of every `stats` tensor: lanes, chunks
# swept (the dense bounce sweeps one per lane), sphere tests, those tests
# with disc >= 0
STATS = ("lanes", "admitted", "tests", "near")


class BounceOut(NamedTuple):
    """One bounce of R lanes (bounce_kernel.py:56-65)."""

    new_o: torch.Tensor     # [R, 3] f32 next origin (unchanged where not scattered)
    new_d: torch.Tensor     # [R, 3] f32 next direction
    atten: torch.Tensor     # [R, 3] f32 this bounce's attenuation (1 where not scattered)
    color: torch.Tensor     # [R, 3] f32 terminal color (sky or black where finished, else 0)
    finished: torch.Tensor  # [R] int32: 1 where an active lane finished
    idx: torch.Tensor       # [R] int32 winning sphere (0 on a miss)
    hit: torch.Tensor       # [R] bool: the ray hit a sphere (before the active mask)
    ruv: torch.Tensor       # [R, 3] f32 the unit-vector draw
    u: torch.Tensor         # [R] f32 the dielectric's uniform draw


def fused_scene_arrays(scene: Scene) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scene_pack [n, 4], attrs [11, n]) f32 on the scene's device: the
    sweep columns cx, cy, cz, r2 per sphere and the winner attributes
    (bounce.py A_*), the scene_arrays of fused_bounce."""
    cols, attrs = scene_sweep_arrays(scene)
    return cols.t().contiguous(), attrs


def bounce_lanes_plain(ray_o, ray_d, active, ray_id, seed: int, draws, n: int,
                       sweep: Callable) -> BounceOut:
    """One bounce of every lane in plain PyTorch, shared by the dense and
    the culled plain bounce: sweep(ox, oy, oz, dx, dy, dz, a, inv_a) ->
    (t, winner attributes) over n spheres, taken _PLAIN_ELEMS / n lanes at
    a time, then shade_vals with the hash draws (or the given ones)."""
    ox, oy, oz = ray_o.unbind(-1)
    dx, dy, dz = ray_d.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    step = max(1, _PLAIN_ELEMS // n)
    parts = [sweep(*(x[i:i + step] for x in (ox, oy, oz, dx, dy, dz, a, inv_a)))
             for i in range(0, ray_o.shape[0], step)]
    t = torch.cat([p[0] for p in parts])
    w = torch.cat([p[1] for p in parts], dim=1)
    if draws is None:
        draws = tuple(hash_u01(ray_id, wrap_i32(seed), k) for k in range(5))
    v = shade_vals(ox, oy, oz, dx, dy, dz, a, active, t, w, tuple(draws))
    return BounceOut(
        new_o=torch.stack(v[0:3], -1), new_d=torch.stack(v[3:6], -1),
        atten=torch.stack(v[6:9], -1), color=torch.stack(v[9:12], -1), finished=v[12],
        idx=v[13], hit=t < BIG * 0.5, ruv=torch.stack(v[14:17], -1), u=v[17])


def fused_bounce_plain(ray_o, ray_d, active, ray_id, scene_arrays, seed: int, *,
                       draws: Optional[Sequence[torch.Tensor]] = None,
                       stats: Optional[torch.Tensor] = None) -> BounceOut:
    """Plain version of the kernel on any device: the dense [R, n] sweep
    and the shading of bounce.py.  Adds the launch's counts to stats [4]
    (STATS) when given."""
    scene_pack, attrs = scene_arrays
    cols = scene_pack.t()
    n = cols.shape[1]

    def sweep(ox, oy, oz, dx, dy, dz, a, inv_a):
        t, ok = sweep_t(ox, oy, oz, dx, dy, dz, a, inv_a, cols)
        if stats is not None:
            r = t.shape[0]
            stats.add_(torch.cat([torch.tensor([r, r, r * n], device=stats.device),
                                  ok.sum().reshape(1)]))
        return winner_of(t, attrs)

    return bounce_lanes_plain(ray_o, ray_d, active, ray_id, seed, draws, n, sweep)


def check_lanes(ray_o, ray_d, active, ray_id, draws, stats) -> int:
    """Check the lane operands of the kernels (CUDA, contiguous: ray_o,
    ray_d [R, 3] f32, active [R] bool, ray_id [R] int32, draws [5, R] f32
    or None, stats [4] int64 or None, all on one device); returns R."""
    r = ray_o.shape[0]
    dev = ray_o.device
    operands = [("ray_o", ray_o, torch.float32, (r, 3)), ("ray_d", ray_d, torch.float32, (r, 3)),
                ("active", active, torch.bool, (r,)), ("ray_id", ray_id, torch.int32, (r,))]
    if draws is not None:
        operands.append(("draws", draws, torch.float32, (5, r)))
    if stats is not None:
        operands.append(("stats", stats, torch.int64, (len(STATS),)))
    for name, x, dtype, shape in operands:
        if x.device.type != "cuda" or x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name} must be a CUDA {dtype} tensor on the lanes' device")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}, got {tuple(x.shape)}")
    if r < 1:
        raise ValueError("need at least one lane")
    return r


def empty_out(r: int, dev) -> BounceOut:
    """The kernels' output tensors, allocated for r lanes."""
    f = dict(dtype=torch.float32, device=dev)
    return BounceOut(
        new_o=torch.empty(r, 3, **f), new_d=torch.empty(r, 3, **f),
        atten=torch.empty(r, 3, **f), color=torch.empty(r, 3, **f),
        finished=torch.empty(r, dtype=torch.int32, device=dev),
        idx=torch.empty(r, dtype=torch.int32, device=dev),
        hit=torch.empty(r, dtype=torch.bool, device=dev), ruv=torch.empty(r, 3, **f),
        u=torch.empty(r, **f))


def lane_args(ray_o, ray_d, active, ray_id, draws, seed: int, r: int, out: BounceOut,
              stats) -> list:
    """The launchers' lane arguments, in csrc/fused_bounce.cu's order."""
    return [ray_o.data_ptr(), ray_d.data_ptr(), active.data_ptr(), ray_id.data_ptr(),
            None if draws is None else draws.data_ptr(), wrap_i32(seed), r,
            *(x.data_ptr() for x in out), None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(ray_o.device).cuda_stream]


LANE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11


def _lib():
    lib = _build.load("fused_bounce")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_bounce_launch.argtypes = [p, p, i] + LANE_ARGTYPES
    lib.fused_bounce_launch.restype = i
    return lib


def group_shape() -> Tuple[int, int]:
    """(lanes per pool lane, threads per block) of the built K10."""
    shape = (ctypes.c_int * 2)()
    _lib().fused_bounce_shape(shape)
    return shape[0], shape[1]


def fused_bounce_cuda(ray_o, ray_d, active, ray_id, scene_arrays, seed: int, *,
                      draws: Optional[torch.Tensor] = None,
                      stats: Optional[torch.Tensor] = None) -> BounceOut:
    """Launch K10 (csrc/fused_bounce.cu) on the current stream (no sync).
    Same arguments and results as fused_bounce_plain; draws, when given,
    is one [5, R] tensor."""
    r = check_lanes(ray_o, ray_d, active, ray_id, draws, stats)
    scene_pack, attrs = scene_arrays
    n = scene_pack.shape[0]
    for name, x, shape in (("scene_pack", scene_pack, (n, 4)), ("attrs", attrs, (A_ROWS, n))):
        if x.device != ray_o.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on the lanes' device")
        if tuple(x.shape) != shape or n < 1:
            raise ValueError(f"{name} must be of shape {shape}, got {tuple(x.shape)}")
    out = empty_out(r, ray_o.device)
    err = _lib().fused_bounce_launch(scene_pack.data_ptr(), attrs.data_ptr(), n,
                                     *lane_args(ray_o, ray_d, active, ray_id, draws, seed, r,
                                                out, stats))
    _build.check(err, "fused_bounce_launch")
    fused_bounce_cuda.launches += 1
    return out


fused_bounce_cuda.launches = 0


def fused_bounce(ray_o, ray_d, active, ray_id, scene_arrays, seed: int, *, draws=None,
                 stats=None) -> BounceOut:
    """One fused bounce of R lanes: ray_o, ray_d [R, 3] f32, active [R]
    bool, ray_id [R] int32 (the draws' key), scene_arrays from
    fused_scene_arrays (any number of spheres), seed the int32 bounce
    seed.  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if ray_o.device.type == "cpu":
        return fused_bounce_plain(ray_o, ray_d, active, ray_id, scene_arrays, seed,
                                  draws=draws, stats=stats)
    if draws is not None:
        draws = torch.stack(tuple(draws)).contiguous()
    return fused_bounce_cuda(ray_o, ray_d, active, ray_id, scene_arrays, seed, draws=draws,
                             stats=stats)
