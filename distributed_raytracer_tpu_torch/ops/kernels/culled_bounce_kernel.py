"""The culled fused bounce: the chunk walk inside the fused bounce (K14).

Port of distributed_raytracer_tpu/ops/pallas/culled_bounce_kernel.py::
culled_fused_bounce (:400; kernel _culled_bounce_kernel :136).  One
bounce of every lane of the wavefront pool against a CulledScene
(ops/kernels/culled_kernel.py): each lane walks the scene's chunks and
sweeps a chunk only when it can still hit the chunk's bounding sphere
closer than its best t so far, then shades with the (ray id, seed)-keyed
hash draws, d = 0..4, bit for bit JAX's keys.  On CUDA tensors
`culled_fused_bounce` launches csrc/fused_bounce.cu's K14, a group of
lanes per pool lane walking the chunks (csrc/trace.cuh group_walk); on
CPU tensors it runs `culled_fused_bounce_plain`: the dense plain bounce
over the culled scene's slots, which also counts what the walk admits
(ops/kernels/mega_walk_kernel.py::walk_sweep).

The pack is the walk's (`WalkPack`: f32 sweep columns, f32 winner
attributes, chunk bounds, chunk lengths) in the culled scene's own chunk
order (the always-swept big chunks, then Morton order), so a slot is an
index into `culled.scene`, as JAX's `_A_IDX` row is, and the walk's
winner is the dense argmin over that scene, ties included.  The TPU
layout (lane-padded sweep rows, chunk-blocked bf16 hi/mid/lo planes) and
its scheduling (the per-block visit plan `_block_visit_plan` with
`visit_sorted_bounds`, block_rays, the double-buffered chunk DMA) have no
counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_raytracer_tpu_torch.ops.kernels import _build
from distributed_raytracer_tpu_torch.ops.kernels.bounce_kernel import (
    LANE_ARGTYPES,
    BounceOut,
    bounce_lanes_plain,
    check_lanes,
    empty_out,
    lane_args,
)
from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import CulledScene, check_counter
from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_kernel import (
    WalkPack,
    check_pack,
    pack_in_order,
    walk_sweep,
)

# the culled fused bounce's scene constants: the walk's pack, slots in the
# culled scene's order
CulledPack = WalkPack


def build_culled_pack(culled: CulledScene) -> CulledPack:
    """The pack of a CulledScene in its own chunk order (culled_bounce_
    kernel.py:82-111 builds the TPU's): slot j is culled.scene's sphere j,
    slot_to_orig is culled.order.  A CPU pack; `.to` moves it."""
    return pack_in_order(culled, np.arange(culled.bounds_r2.shape[0], dtype=np.int64))


def culled_fused_bounce_plain(ray_o, ray_d, active, ray_id, pack: CulledPack, seed: int, *,
                              draws: Optional[Sequence[torch.Tensor]] = None,
                              stats: Optional[torch.Tensor] = None) -> BounceOut:
    """Plain version of the kernel on any device: the dense plain bounce
    over the pack's slots (fused_bounce_plain's arithmetic; a cull that is
    not conservative would show as a difference), adding to stats [4]
    (bounce_kernel.STATS) the lanes and what the walk admits."""
    cols = pack.scene_pack.t()
    tally = torch.zeros(3, dtype=torch.int64, device=cols.device)
    out = bounce_lanes_plain(ray_o, ray_d, active, ray_id, seed, draws, cols.shape[1],
                             walk_sweep(cols, pack.attrs, pack.bounds, pack.n_chunks, tally))
    if stats is not None:
        stats.add_(torch.cat([torch.tensor([ray_o.shape[0]], device=stats.device),
                              tally.to(stats.device)]))
    return out


def _lib():
    lib = _build.load("fused_bounce")
    p, i = ctypes.c_void_p, ctypes.c_int
    # the lane arguments, then the issued-lanes counter before the stream
    lib.culled_fused_bounce_launch.argtypes = ([p, p, p, p, i, i, i] + LANE_ARGTYPES[:-1]
                                               + [p, p])
    lib.culled_fused_bounce_launch.restype = i
    return lib


def group_shape() -> Tuple[int, int]:
    """(lanes per pool lane, threads per block) of the built K14."""
    shape = (ctypes.c_int * 2)()
    _lib().culled_fused_bounce_shape(shape)
    return shape[0], shape[1]


def culled_fused_bounce_cuda(ray_o, ray_d, active, ray_id, pack: CulledPack, seed: int, *,
                             draws: Optional[torch.Tensor] = None,
                             stats: Optional[torch.Tensor] = None,
                             issued: Optional[torch.Tensor] = None) -> BounceOut:
    """Launch K14 (csrc/fused_bounce.cu) on the current stream (no
    sync).  Same arguments and results as culled_fused_bounce_plain;
    draws, when given, is one [5, R] tensor; issued, int64 [1], gains the
    slot-test lanes the groups issued."""
    r = check_lanes(ray_o, ray_d, active, ray_id, draws, stats)
    check_counter(issued, "issued", 1, ray_o.device)
    n, chunk, n_chunks = check_pack(pack.scene_pack, pack.attrs, pack.bounds, pack.chunk_len,
                                    ray_o.device)
    out = empty_out(r, ray_o.device)
    *args, stream = lane_args(ray_o, ray_d, active, ray_id, draws, seed, r, out, stats)
    err = _lib().culled_fused_bounce_launch(
        pack.scene_pack.data_ptr(), pack.attrs.data_ptr(), pack.bounds.data_ptr(),
        pack.chunk_len.data_ptr(), n, chunk, n_chunks, *args,
        None if issued is None else issued.data_ptr(), stream)
    _build.check(err, "culled_fused_bounce_launch")
    culled_fused_bounce_cuda.launches += 1
    return out


culled_fused_bounce_cuda.launches = 0


def culled_fused_bounce(ray_o, ray_d, active, ray_id, pack: CulledPack, seed: int, *,
                        draws=None, stats=None) -> BounceOut:
    """One culled fused bounce of R lanes (fused_bounce's operands, the
    scene as build_culled_pack's pack on the lanes' device): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if ray_o.device.type == "cpu":
        return culled_fused_bounce_plain(ray_o, ray_d, active, ray_id, pack, seed, draws=draws,
                                         stats=stats)
    if draws is not None:
        draws = torch.stack(tuple(draws)).contiguous()
    return culled_fused_bounce_cuda(ray_o, ray_d, active, ray_id, pack, seed, draws=draws,
                                    stats=stats)
