"""The recording forward: one image sample, or one batch of given rays,
and the tape its backward walks.

Port of distributed_raytracer_tpu/ops/pallas/mega_kernel.py in its two
modes: camera mode with recorded winner params and packed int columns
(`mega_forward_camera` there, the forward of the scene- and pose-gradient
tracers) and ray mode (`mega_forward`, the forward of the ray-table
tracer).  On CUDA tensors `mega_forward_camera` and `mega_forward` launch
the hand-written kernel csrc/mega_forward.cu; on CPU tensors they run
`mega_forward_camera_plain` and `mega_forward_plain`, the same arithmetic
in plain PyTorch (the plain render's trace, recording).

In camera mode every draw is the render kernel's (rid, depth)-keyed hash
with rid = the pixel id, so at equal seeds the colors equal
`mega_render_colors` of sample 0 bit for bit.  In ray mode the primary
rays are a ray table [R, 3] x 2 and rid is the ray's index (JAX's lane
ray with no rid base): the bounce draws are keyed (i, bounce_seed + depth
* 65537), and there are no camera draws.  So ray mode given the rays
camera_rays_host makes for pixels 0..R-1 (rid = pix) traces what camera
mode traces, bit for bit.

The tape is depth-major, [max_depth, R, 32] f32: ray i's row at depth k
is tape[k, i], holding the pre-bounce state, the draws, the contribution,
the winner's parameters and, as int32 bits, the winner index, the ray and
the flags (columns T_* below; JAX's row meaning).  Both modes record the
winner's parameters (JAX's ray mode does not), so either backward, K7
(parameters re-read from the scene) or K8 (read off the tape), can walk
either tape.  Rows at depth >= lengths[i] are never written
(torch.empty).  The TPU arguments pool, budget, block_rays, pad_rows,
cam_out and variant are scheduling and layout and have no counterpart:
every ray runs to its end, so nothing is truncated, and there is no clean
flag and no NaN poisoning.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from distributed_raytracer_tpu_torch.core.vecmath import BIG
from distributed_raytracer_tpu_torch.ops.kernels import _build
from distributed_raytracer_tpu_torch.ops.kernels.bounce import A_IDX
from distributed_raytracer_tpu_torch.ops.kernels.hash import wrap_i32
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import (
    camera_rays_host,
    check_sweep_args,
    trace_plain,
)

# tape columns (mega_kernel.py:96-99, mega_walk_bwd_kernel.py:55); the
# kernels name them in csrc/tape.cuh, with the same names and values
T_O, T_D, T_AT, T_RU, T_U, T_CO = 0, 3, 6, 9, 12, 13
T_CW, T_RW, T_AW, T_FW, T_IW, T_MT = 16, 19, 20, 23, 24, 25
T_IDX, T_RAY, T_FLG = 26, 27, 28   # int32 bits
TAPE_COLS = 32
F_HIT, F_ACT, F_TAKE, F_FIN = 1, 2, 4, 8


class MegaOut(NamedTuple):
    tape: torch.Tensor     # [max_depth, R, 32] f32, rows < lengths written
    lengths: torch.Tensor  # [R] int32 rows per ray
    colors: torch.Tensor   # [R, 3] f32
    bounces: torch.Tensor  # [1] int64 (ray, bounce) sweeps run
    # [1] int64 (warp, step) pairs of the kernel that swept; None from the
    # plain versions, which have no warps
    warp_steps: Optional[torch.Tensor] = None


def lane_use(bounces: int, warp_steps: int, warp: int = 32) -> float:
    """The share of the sweeping warps' lanes that held a live ray: the
    bounces run over `warp` x the (warp, step) pairs that swept."""
    return bounces / (warp * warp_steps) if warp_steps else 0.0


def sweep_lane_use(tests: int, warp_tests: int, warp: int = 32) -> float:
    """The share of a warp's lanes that test a walk chunk's slots for a ray
    that admitted the chunk, while the warp sweeps it: the slot tests of
    admitted chunks (per lane) over `warp` x the slot-test rounds the warps
    issued (for each chunk that any lane of a warp admitted, its length
    when the lanes sweep it alone, or the admitting rays x its rounds when
    the warp sweeps it together; csrc/trace.cuh WalkChunks).  Idle lanes
    (no live ray) and lanes whose ray did not admit the chunk both lower
    it."""
    return tests / (warp * warp_tests) if warp_tests else 0.0


def group_lane_use(tests: int, issued: int) -> float:
    """The share of the slot-test lanes that the group walk's groups
    issue (csrc/trace.cuh group_walk: G lanes hold one ray and test an
    admitted chunk's slots in rounds of G, so a chunk of len slots takes
    G x ceil(len / G) lanes) that test a slot: the slot tests of admitted
    chunks over those lanes.  Only a chunk's last round can leave lanes
    idle."""
    return tests / issued if issued else 0.0


def static_lane_use(lengths: torch.Tensor, warp: int = 32) -> float:
    """The lane use of one thread per ray in static warps of `warp`
    consecutive rays (K5 and K6 before the persistent loop), each of which
    sweeps until its longest ray ends: the bounces over `warp` x the sum
    of each warp's longest length.  A last partial warp counts whole."""
    lengths = lengths.to(torch.int64).flatten()
    padded = torch.nn.functional.pad(lengths, (0, (-lengths.numel()) % warp))
    return lane_use(int(lengths.sum()), int(padded.view(-1, warp).max(dim=1).values.sum()),
                    warp)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.float32)


def _record_plain(cols, attrs, o, d, rid, *, bounce_seed: int, max_depth: int,
                  sweep: Optional[Callable]) -> MegaOut:
    """trace_plain of the primary rays (o, d) with ray ids rid, recording
    the tape."""
    dev = cols.device
    n_rays = rid.shape[0]
    tape = torch.empty(max_depth, n_rays, TAPE_COLS, dtype=torch.float32, device=dev)
    lengths = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    colors = torch.zeros(n_rays, 3, dtype=torch.float32, device=dev)

    def record(depth, rays, o, d, atten, v, t, win, fin):
        hit = t < BIG * 0.5
        flags = (hit.to(torch.int32) * F_HIT + F_ACT + (F_TAKE if depth == 0 else 0)
                 + fin.to(torch.int32) * F_FIN)
        zero = torch.zeros_like(t)
        cols_ = ([*o.unbind(-1), *d.unbind(-1), *atten.unbind(-1), v[14], v[15], v[16], v[17]]
                 + [atten[:, k] * v[9 + k] for k in range(3)]
                 + [win[k] for k in range(A_IDX)]
                 + [_bits(win[A_IDX]), _bits(rays), _bits(flags), zero, zero, zero])
        tape[depth, rays] = torch.stack(cols_, -1)
        lengths[rays] = depth + 1

    bounces = trace_plain(cols, attrs, o, d, rid, bounce_seed=bounce_seed, max_depth=max_depth,
                          colors=colors, record=record, sweep=sweep)
    return MegaOut(tape, lengths, colors, torch.tensor([bounces], dtype=torch.int64, device=dev))


def mega_forward_camera_plain(cols, attrs, cam_row, pixel_ids: Optional[torch.Tensor], *,
                              bounce_seed: int, cam_seed: int, pix0: int, n_valid: int, w: int,
                              max_depth: int, sweep: Optional[Callable] = None) -> MegaOut:
    """Plain PyTorch version of the camera-mode recording forward on any
    device.  pixel_ids [n_valid] int, or None for pix0 + arange(n_valid);
    sweep: trace_plain's."""
    if pixel_ids is None:
        pix = pix0 + torch.arange(n_valid, dtype=torch.int64, device=cols.device)
    else:
        pix = pixel_ids.to(torch.int64)
    rid = pix & 0xFFFFFFFF
    o, d = camera_rays_host(cam_row, pix, rid, cam_seed, w)
    return _record_plain(cols, attrs, o, d, rid, bounce_seed=bounce_seed, max_depth=max_depth,
                         sweep=sweep)


def mega_forward_plain(cols, attrs, ray_o, ray_d, *, bounce_seed: int, max_depth: int,
                       sweep: Optional[Callable] = None) -> MegaOut:
    """Plain PyTorch version of the ray-mode recording forward on any
    device: the rays ray_o, ray_d [R, 3] f32, ray i's draws keyed by i."""
    rid = torch.arange(ray_o.shape[0], dtype=torch.int64, device=cols.device)
    return _record_plain(cols, attrs, ray_o, ray_d, rid, bounce_seed=bounce_seed,
                         max_depth=max_depth, sweep=sweep)


def _argtypes(fn):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, i, p, p, p, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(cols, attrs, n: int, cam_row, pixel_ids, ray_o, ray_d, *, bounce_seed: int,
            cam_seed: int, pix0: int, n_valid: int, w: int, max_depth: int,
            grid: Optional[int]) -> MegaOut:
    """Launch csrc/mega_forward.cu in camera mode (cam_row given) or ray
    mode (ray_o, ray_d given) on the current stream, on at most `grid`
    blocks (by default as many as fit the card at once)."""
    if n_valid < 1 or max_depth < 1:
        raise ValueError(f"need n_valid >= 1 and max_depth >= 1, got {n_valid}, {max_depth}")
    dev = cols.device
    ray_mode = int(ray_o is not None)
    grid = grid or _build.occupancy_grid("mega_forward", "mega_forward_blocks_per_sm", dev,
                                         ray_mode)
    tape = torch.empty(max_depth, n_valid, TAPE_COLS, dtype=torch.float32, device=dev)
    lengths = torch.empty(n_valid, dtype=torch.int32, device=dev)
    colors = torch.empty(n_valid, 3, dtype=torch.float32, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)  # bounces, warp steps, next ray
    ptr = lambda x: None if x is None else x.data_ptr()
    fn = _argtypes(_build.load("mega_forward").mega_forward_launch)
    err = fn(cols.data_ptr(), attrs.data_ptr(), n, ptr(cam_row), ptr(pixel_ids), ptr(ray_o),
             ptr(ray_d), wrap_i32(bounce_seed), wrap_i32(cam_seed), pix0, n_valid, w,
             max_depth, tape.data_ptr(), lengths.data_ptr(), colors.data_ptr(),
             counts.data_ptr(), grid, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mega_forward_launch")
    return MegaOut(tape, lengths, colors, counts[0:1], counts[1:2])


def mega_forward_camera_cuda(cols, attrs, cam_row, pixel_ids: Optional[torch.Tensor], *,
                             bounce_seed: int, cam_seed: int, pix0: int, n_valid: int, w: int,
                             max_depth: int, grid: Optional[int] = None) -> MegaOut:
    """Launch csrc/mega_forward.cu in camera mode on the current stream (no
    sync).  Same arguments and results as mega_forward_camera_plain, and
    the kernel's warp steps; grid as _launch's."""
    n = check_sweep_args(cols, attrs, cam_row)
    if pixel_ids is not None and (pixel_ids.device != cols.device or pixel_ids.dtype != torch.int32
                                  or tuple(pixel_ids.shape) != (n_valid,)
                                  or not pixel_ids.is_contiguous()):
        raise ValueError(f"pixel_ids must be a contiguous int32 tensor of shape ({n_valid},) "
                         f"on {cols.device}")
    out = _launch(cols, attrs, n, cam_row, pixel_ids, None, None, bounce_seed=bounce_seed,
                  cam_seed=cam_seed, pix0=pix0, n_valid=n_valid, w=w, max_depth=max_depth,
                  grid=grid)
    mega_forward_camera_cuda.launches += 1
    return out


mega_forward_camera_cuda.launches = 0


def mega_forward_cuda(cols, attrs, ray_o, ray_d, *, bounce_seed: int,
                      max_depth: int, grid: Optional[int] = None) -> MegaOut:
    """Launch csrc/mega_forward.cu in ray mode on the current stream (no
    sync).  Same arguments and results as mega_forward_plain, and the
    kernel's warp steps; grid as _launch's."""
    n = check_sweep_args(cols, attrs, None)
    r = ray_o.shape[0]
    for name, x in (("ray_o", ray_o), ("ray_d", ray_d)):
        if (x.device != cols.device or x.dtype != torch.float32 or tuple(x.shape) != (r, 3)
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor of shape ({r}, 3) "
                             f"on {cols.device}")
    out = _launch(cols, attrs, n, None, None, ray_o, ray_d, bounce_seed=bounce_seed, cam_seed=0,
                  pix0=0, n_valid=r, w=1, max_depth=max_depth, grid=grid)
    mega_forward_cuda.launches += 1
    return out


mega_forward_cuda.launches = 0


def mega_forward_camera(cols, attrs, cam_row, pixel_ids: Optional[torch.Tensor], **kw) -> MegaOut:
    """The camera-mode recording forward: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if cols.device.type == "cpu":
        return mega_forward_camera_plain(cols, attrs, cam_row, pixel_ids, **kw)
    return mega_forward_camera_cuda(cols, attrs, cam_row, pixel_ids, **kw)


def mega_forward(cols, attrs, ray_o, ray_d, **kw) -> MegaOut:
    """The ray-mode recording forward: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if cols.device.type == "cpu":
        return mega_forward_plain(cols, attrs, ray_o, ray_d, **kw)
    return mega_forward_cuda(cols, attrs, ray_o, ray_d, **kw)
