"""The reverse tape walk: scene-parameter cotangents from the recorded tape.

Port of distributed_raytracer_tpu/ops/pallas/mega_walk_bwd_kernel.py
(`mega_walk_backward` with the packed tape, the backward of the scene-
and pose-gradient tracers, with and without `ray_grads`), with its VJP
body mega_bwd_kernel.py::_local_f_rows as ops/kernels/local_f.py.  On a
CUDA tensor `mega_walk_backward` launches the hand-written kernel
csrc/mega_walk_bwd.cu; on a CPU tensor it runs `mega_walk_backward_plain`:
the same walk with torch autograd of local_f_rows as each row's VJP.

Every entry returns g_pm [n + 1, 9]: per-sphere cotangents of (center 3,
radius, albedo 3, fuzz, ior), row n being the no-hit bin; with
ray_grads=True it returns (g_pm, g_ray), g_ray [R, 6] the cotangents of
each ray's primary origin and direction (zero for a ray with no rows or
that did not finish).  n is any count: the dense tracer's spheres (at most
512) or the walk tracer's slots (8,448 at the bench's 8,192 spheres); the
kernel sums the first 513 bins in shared memory (every bin up to 512
spheres) and the rest with global atomics.

The kernel is persistent (csrc/walk_bwd.cuh): a grid of SMs x blocks per
SM (`_build.occupancy_grid`) of blocks that each walk a pool of reverse
carries one row per step and refill it from a global ray counter, in the
order `order` gives: by default the longest rays first (`longest_first`, a
stable sort of the lengths' log2 classes in the wrapper), so that the
pools end on short rays and drain in a few steps.  It counts the rows
walked and the warp steps (WALK_STATS), whose ratio is its lane use
(`mega_kernel.lane_use`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from distributed_raytracer_tpu_torch.ops.kernels import _build
from distributed_raytracer_tpu_torch.ops.kernels.local_f import local_f_rows
from distributed_raytracer_tpu_torch.ops.kernels.mega_kernel import (
    F_ACT,
    F_FIN,
    F_HIT,
    T_AT,
    T_CW,
    T_FLG,
    T_IDX,
    T_IW,
    T_MT,
    T_RU,
    T_U,
    TAPE_COLS,
)

N_PARAMS = 9
# the reverse walk's counters: the rows walked (rays that cannot contribute
# are dropped before their first row, a carry that vanishes ends its walk)
# and the (warp, step) pairs that walked a row
WALK_STATS = ("rows", "warp_steps")


def int_col(rows: torch.Tensor, col: int) -> torch.Tensor:
    """Column col of tape rows [m, 32], read as the int32 it holds."""
    return rows[:, col].contiguous().view(torch.int32)


def _check_args(tape, lengths, g_color, n):
    r = lengths.shape[0]
    if tape.dim() != 3 or tape.shape[1:] != (r, TAPE_COLS) or tape.dtype != torch.float32:
        raise ValueError(f"tape must be float32 [depth, {r}, {TAPE_COLS}], got "
                         f"{tape.dtype} {tuple(tape.shape)}")
    if lengths.dtype != torch.int32 or tuple(g_color.shape) != (r, 3):
        raise ValueError(f"need int32 lengths [{r}] and g_color [{r}, 3], got "
                         f"{lengths.dtype} and {tuple(g_color.shape)}")
    if n < 1:
        raise ValueError(f"need n >= 1 spheres, got {n}")


def walk_plain(tape, lengths, g_color, n: int, params, dtype: torch.dtype = torch.float32,
               ray_grads: bool = False):
    """The plain reverse walk of K7 and K8 on any device, with torch
    autograd as the VJP.  Depth by depth from the deepest, each live row's
    inputs (o, d, atten off the tape, the winner's parameters from
    params(rows, hit) -> ([m, 9], material [m])) are taken in dtype, its
    output cotangents are the carry from the row after plus g_color at a
    finishing row, and autograd of local_f_rows gives its input
    cotangents: (o, d, atten)'s are carried to the row before, the
    parameters' are summed into the winner's bin (bin n when the row hit
    nothing).  Like the kernels, each row is linearized at its recorded
    state, not at a replayed one.  The carry left at each ray's first row
    holds its primary-ray cotangents.  dtype is the arithmetic's
    precision: float64 evaluates the same walk on the same f32 tape with
    little rounding, a referee for the f32 versions."""
    _check_args(tape, lengths, g_color, n)
    dev = tape.device
    g_pm = torch.zeros(n + 1, N_PARAMS, dtype=dtype, device=dev)
    lens = lengths.to(torch.int64)
    carry = torch.zeros(lengths.shape[0], 9, dtype=dtype, device=dev)
    for depth in range(tape.shape[0] - 1, -1, -1):
        rays = torch.nonzero(lens > depth).squeeze(1)
        if rays.numel() == 0:
            continue
        rows = tape[depth, rays].detach()
        flags = int_col(rows, T_FLG)
        hit = (flags & F_HIT) != 0
        fin = (flags & F_FIN) != 0
        vals = rows.to(dtype)
        pv, mt = params(rows, hit)
        x = vals[:, :T_AT + 3].clone().requires_grad_()
        p = pv.to(dtype).clone().requires_grad_()
        with torch.enable_grad():
            out = local_f_rows(*x.unbind(-1), *p.unbind(-1), mt.to(dtype), vals[:, T_RU],
                               vals[:, T_RU + 1], vals[:, T_RU + 2], vals[:, T_U], hit,
                               (flags & F_ACT) != 0)
            cot = torch.cat([carry[rays], torch.where(fin[:, None], g_color[rays].to(dtype),
                                                      0.0)], 1)
            used = [k for k in range(12) if out[k].requires_grad]
            gx, gp = torch.autograd.grad([out[k] for k in used], [x, p],
                                         [cot[:, k] for k in used], allow_unused=True)
        if gx is not None:
            carry[rays] = gx
        if gp is not None:
            g_pm.index_add_(0, torch.where(hit, int_col(rows, T_IDX), n).to(torch.int64), gp)
    if ray_grads:
        return g_pm, carry[:, :6].contiguous()
    return g_pm


def _tape_params(rows, hit):
    """The winner's parameters and material as recorded on the rows."""
    return rows[:, T_CW:T_IW + 1], rows[:, T_MT]


def mega_walk_backward_plain(tape, lengths, g_color, n: int,
                             dtype: torch.dtype = torch.float32, ray_grads: bool = False):
    """Plain version of K8 on any device: walk_plain with the winner's
    parameters read off the tape."""
    return walk_plain(tape, lengths, g_color, n, _tape_params, dtype, ray_grads)


def check_walk_cuda_args(tape, lengths, g_color, n):
    """The checks of a reverse-walk kernel's tape operands (CUDA,
    contiguous, on the tape's device; float32 g_color)."""
    _check_args(tape, lengths, g_color, n)
    for name, x in (("tape", tape), ("lengths", lengths), ("g_color", g_color)):
        if x.device.type != "cuda" or x.device != tape.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on the tape's CUDA device")
    if g_color.dtype != torch.float32:
        raise ValueError("g_color must be float32")


def longest_first(lengths: torch.Tensor) -> torch.Tensor:
    """[R] int32: the reverse walks' default feed order.  The rays by
    descending length class ceil(log2(length)) (1, 2, 3-4, 5-8, ... rows),
    index order within a class (a stable sort): the long rays start early,
    so the pools drain in a few steps, and the rays of a class keep the
    tape's order, in which neighbours tend to walk the same materials.
    scripts/torch_persist_grid.py measured it against index order and an
    exact length order (PERF.md section 6)."""
    cls = torch.ceil(torch.log2(lengths.clamp(min=1).to(torch.float32))).to(torch.int32)
    return torch.sort(cls, descending=True, stable=True).indices.to(torch.int32)


def launch_walk(fn, lead: tuple, tape, lengths, g_color, n: int, ray_grads: bool,
                grid: int, order: Optional[torch.Tensor], with_stats: bool):
    """Launch a reverse-walk kernel of csrc/walk_bwd.cuh (K8: lead = (), K7:
    lead = (cols, attrs)) on the current stream; returns g_pm, or (g_pm,
    g_ray) with ray_grads, and then the [2] int64 WALK_STATS with
    with_stats."""
    r = lengths.shape[0]
    dev = tape.device
    if order is None:
        order = longest_first(lengths)
    elif (order.device != dev or order.dtype != torch.int32 or tuple(order.shape) != (r,)
          or not order.is_contiguous()):
        raise ValueError(f"order must be a contiguous int32 tensor of shape ({r},) on {dev}")
    g_pm = torch.zeros(n + 1, N_PARAMS, dtype=torch.float32, device=dev)
    g_ray = torch.zeros(r, 6, dtype=torch.float32, device=dev) if ray_grads else None
    counts = torch.zeros(3, dtype=torch.int64, device=dev)  # rows, warp steps, next ray
    ptr = lambda x: None if x is None else x.data_ptr()
    err = fn(*(x.data_ptr() for x in lead), tape.data_ptr(), lengths.data_ptr(),
             g_color.data_ptr(), order.data_ptr(), r, n, grid, g_pm.data_ptr(), ptr(g_ray),
             counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, fn.__name__)
    out = (g_pm, g_ray) if ray_grads else (g_pm,)
    if with_stats:
        out = out + (counts[:2],)
    return out if len(out) > 1 else out[0]


def mega_walk_backward_cuda(tape, lengths, g_color, n: int, ray_grads: bool = False,
                            grid: Optional[int] = None, order: Optional[torch.Tensor] = None,
                            with_stats: bool = False):
    """Launch csrc/mega_walk_bwd.cu on the current stream (no sync).  Same
    arguments and result as mega_walk_backward_plain.  grid: the most
    blocks of the persistent kernel (by default as many as fit the card
    at once; 1 makes one block walk every ray); order: the order in which
    the rays are fed ([R] int32 permutation; by default longest_first);
    with_stats: also return the [2] int64 WALK_STATS."""
    check_walk_cuda_args(tape, lengths, g_color, n)
    dev = tape.device
    grid = grid or _build.occupancy_grid("mega_walk_bwd", "mega_walk_bwd_blocks_per_sm", dev,
                                         int(ray_grads))
    fn = _build.load("mega_walk_bwd").mega_walk_bwd_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, p, p, p, p]
    fn.restype = i
    out = launch_walk(fn, (), tape, lengths, g_color, n, ray_grads, grid, order, with_stats)
    if ray_grads:
        mega_walk_backward_cuda.ray_launches += 1
    else:
        mega_walk_backward_cuda.launches += 1
    return out


mega_walk_backward_cuda.launches = 0      # without ray grads
mega_walk_backward_cuda.ray_launches = 0  # with ray grads


def mega_walk_backward(tape, lengths, g_color, n: int, ray_grads: bool = False):
    """Scene-parameter cotangents [n + 1, 9] (and with ray_grads the
    primary-ray cotangents [R, 6]): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if tape.device.type == "cpu":
        return mega_walk_backward_plain(tape, lengths, g_color, n, ray_grads=ray_grads)
    return mega_walk_backward_cuda(tape, lengths, g_color, n, ray_grads=ray_grads)
