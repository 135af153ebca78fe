"""The dense reverse tape walk with the winner's parameters re-read from
the scene: the backward of the ray-table tracer.

Port of distributed_raytracer_tpu/ops/pallas/mega_bwd_kernel.py
(`mega_backward`, the backward of make_tape_tracer(use_mega=True,
mega_bwd=True)).  On CUDA tensors `mega_backward` launches the
hand-written kernel csrc/mega_bwd.cu; on CPU tensors it runs
`mega_backward_plain`: K8's plain walk (mega_walk_bwd_kernel.walk_plain)
with each row's parameters gathered from the scene by its recorded winner
index.  On a tape of the same scene the parameters it gathers are the
ones the recording forward wrote, so it computes what K8 computes there.

It returns g_pm [n + 1, 9] (per-sphere cotangents of center 3, radius,
albedo 3, fuzz, ior; row n the no-hit bin) and, with ray_grads=True (the
default, as in JAX), (g_pm, g_ray): g_ray [R, 6] the cotangents of each
ray's primary (o, d), written per ray where JAX emits dense [T, 8, B]
rows that the caller gathers at the refill positions.  The scene is at
most 512 spheres (the dense tracer's): cols [4, n] and attrs [11, n] of
bounce.scene_sweep_arrays.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from distributed_raytracer_tpu_torch.ops.kernels import _build
from distributed_raytracer_tpu_torch.ops.kernels.bounce import (
    A_AB,
    A_AG,
    A_AR,
    A_FZ,
    A_IO,
    A_MT,
    A_RR,
)
from distributed_raytracer_tpu_torch.ops.kernels.mega_kernel import T_IDX
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import check_sweep_args
from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_bwd_kernel import (
    check_walk_cuda_args,
    int_col,
    launch_walk,
    walk_plain,
)


def _scene_params(cols, attrs):
    """params(rows, hit) for walk_plain, as the kernel reads them: the
    winner's center from the sweep columns, its radius, albedo, fuzz, ior
    and material from the attributes, by the rows' winner index; zeros on
    a miss (as the recording forward writes)."""
    rows_ = [A_RR, A_AR, A_AG, A_AB, A_FZ, A_IO]

    def params(rows, hit):
        idx = int_col(rows, T_IDX).to(torch.int64)
        w = torch.where(hit[None, :], torch.cat([cols[0:3, idx], attrs[:, idx]]), 0.0)
        return torch.cat([w[0:3], w[[3 + k for k in rows_]]]).T, w[3 + A_MT]

    return params


def mega_backward_plain(cols, attrs, tape, lengths, g_color, n: int,
                        dtype: torch.dtype = torch.float32, ray_grads: bool = True):
    """Plain version of K7 on any device: the reverse walk with each
    row's parameters gathered from (cols, attrs) by its winner index."""
    return walk_plain(tape, lengths, g_color, n, _scene_params(cols, attrs), dtype, ray_grads)


def mega_backward_cuda(cols, attrs, tape, lengths, g_color, n: int, ray_grads: bool = True,
                       grid: Optional[int] = None, order: Optional[torch.Tensor] = None,
                       with_stats: bool = False):
    """Launch csrc/mega_bwd.cu on the current stream (no sync).  Same
    arguments and result as mega_backward_plain; grid, order and
    with_stats as mega_walk_backward_cuda's."""
    if check_sweep_args(cols, attrs, None) != n:
        raise ValueError(f"the scene arrays hold {cols.shape[1]} spheres, not n = {n}")
    check_walk_cuda_args(tape, lengths, g_color, n)
    if cols.device != tape.device:
        raise ValueError("the scene arrays must be on the tape's device")
    dev = tape.device
    grid = grid or _build.occupancy_grid("mega_bwd", "mega_bwd_blocks_per_sm", dev,
                                         int(ray_grads))
    fn = _build.load("mega_bwd").mega_bwd_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, p, p, p, p]
    fn.restype = i
    out = launch_walk(fn, (cols, attrs), tape, lengths, g_color, n, ray_grads, grid, order,
                      with_stats)
    mega_backward_cuda.launches += 1
    return out


mega_backward_cuda.launches = 0


def mega_backward(cols, attrs, tape, lengths, g_color, n: int, ray_grads: bool = True):
    """Scene-parameter cotangents [n + 1, 9] (and with ray_grads the
    primary-ray cotangents [R, 6]): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if tape.device.type == "cpu":
        return mega_backward_plain(cols, attrs, tape, lengths, g_color, n, ray_grads=ray_grads)
    return mega_backward_cuda(cols, attrs, tape, lengths, g_color, n, ray_grads=ray_grads)
