"""The recording forward: one image sample and the tape its backward walks.

Port of distributed_raytracer_tpu/ops/pallas/mega_kernel.py in camera
mode with recorded winner params and packed int columns (the forward of
the scene-gradient tracer, `mega_forward_camera` there).  On a CUDA
tensor `mega_forward_camera` launches the hand-written kernel
csrc/mega_forward.cu; on a CPU tensor it runs `mega_forward_camera_plain`,
the same arithmetic in plain PyTorch (the plain render's trace, recording).

Every draw is the render kernel's (rid, depth)-keyed hash with rid = the
pixel id, so at equal seeds the colors equal `mega_render_colors` of
sample 0 bit for bit.

The tape is depth-major, [max_depth, R, 32] f32: ray i's row at depth k
is tape[k, i], holding the pre-bounce state, the draws, the contribution,
the winner's parameters and, as int32 bits, the winner index, the ray and
the flags (columns T_* below; JAX's row meaning).  Rows at depth >=
lengths[i] are never written (torch.empty).  The TPU arguments pool,
budget, block_rays, pad_rows, cam_out and variant are scheduling and
layout and have no counterpart: every ray runs to its end, so nothing is
truncated, and there is no clean flag and no NaN poisoning.
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


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.float32)


def mega_forward_camera_plain(cols, attrs, cam_row, pixel_ids: Optional[torch.Tensor], *,
                              bounce_seed: int, cam_seed: int, pix0: int, n_valid: int, w: int,
                              max_depth: int, sweep: Optional[Callable] = None) -> MegaOut:
    """Plain PyTorch version of the recording forward on any device.
    pixel_ids [n_valid] int, or None for pix0 + arange(n_valid); sweep:
    trace_plain's."""
    dev = cols.device
    if pixel_ids is None:
        pix = pix0 + torch.arange(n_valid, dtype=torch.int64, device=dev)
    else:
        pix = pixel_ids.to(torch.int64)
    tape = torch.empty(max_depth, n_valid, TAPE_COLS, dtype=torch.float32, device=dev)
    lengths = torch.zeros(n_valid, dtype=torch.int32, device=dev)
    colors = torch.zeros(n_valid, 3, dtype=torch.float32, device=dev)

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

    bounces = trace_plain(cols, attrs, cam_row, pix, pix & 0xFFFFFFFF, bounce_seed=bounce_seed,
                          cam_seed=cam_seed, w=w, max_depth=max_depth, colors=colors,
                          record=record, sweep=sweep)
    return MegaOut(tape, lengths, colors, torch.tensor([bounces], dtype=torch.int64, device=dev))


def _argtypes(fn):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def mega_forward_camera_cuda(cols, attrs, cam_row, pixel_ids: Optional[torch.Tensor], *,
                             bounce_seed: int, cam_seed: int, pix0: int, n_valid: int, w: int,
                             max_depth: int) -> MegaOut:
    """Launch csrc/mega_forward.cu on the current stream (no sync).  Same
    arguments and results as mega_forward_camera_plain."""
    n = check_sweep_args(cols, attrs, cam_row)
    if pixel_ids is not None and (pixel_ids.device != cols.device or pixel_ids.dtype != torch.int32
                                  or tuple(pixel_ids.shape) != (n_valid,)
                                  or not pixel_ids.is_contiguous()):
        raise ValueError(f"pixel_ids must be a contiguous int32 tensor of shape ({n_valid},) "
                         f"on {cols.device}")
    if n_valid < 1 or max_depth < 1:
        raise ValueError(f"need n_valid >= 1 and max_depth >= 1, got {n_valid}, {max_depth}")
    dev = cols.device
    tape = torch.empty(max_depth, n_valid, TAPE_COLS, dtype=torch.float32, device=dev)
    lengths = torch.empty(n_valid, dtype=torch.int32, device=dev)
    colors = torch.empty(n_valid, 3, dtype=torch.float32, device=dev)
    bounces = torch.zeros(1, dtype=torch.int64, device=dev)
    fn = _argtypes(_build.load("mega_forward").mega_forward_launch)
    err = fn(cols.data_ptr(), attrs.data_ptr(), n, cam_row.data_ptr(),
             None if pixel_ids is None else pixel_ids.data_ptr(), wrap_i32(bounce_seed),
             wrap_i32(cam_seed), pix0, n_valid, w, max_depth, tape.data_ptr(),
             lengths.data_ptr(), colors.data_ptr(), bounces.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mega_forward_launch")
    mega_forward_camera_cuda.launches += 1
    return MegaOut(tape, lengths, colors, bounces)


mega_forward_camera_cuda.launches = 0


def mega_forward_camera(cols, attrs, cam_row, pixel_ids: Optional[torch.Tensor], **kw) -> MegaOut:
    """The recording forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if cols.device.type == "cpu":
        return mega_forward_camera_plain(cols, attrs, cam_row, pixel_ids, **kw)
    return mega_forward_camera_cuda(cols, attrs, cam_row, pixel_ids, **kw)
