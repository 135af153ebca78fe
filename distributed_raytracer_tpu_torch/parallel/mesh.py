"""The mesh of ranks and its collectives: the port of distributed_raytracer_tpu/
parallel/mesh.py on torch.distributed.

A mesh lays the ranks of a job out as a grid of n_rays x n_scene, rank r
at row r // n_scene, column r % n_scene (JAX's device array reshaped to
("rays", "scene")):

  - "rays": data parallelism over the pixel/ray grid.  The ranks of one
    column (same scene index) hold different rays; their process group is
    the column's `rays_group`.
  - "scene": sharding of the sphere axis.  The ranks of one row (same rays
    index) hold different blocks of spheres; their group is `scene_group`.

An axis of size 1 needs no group and its collectives are the identity, so
a 1 x 1 mesh works without torch.distributed.  A mesh built directly,
`Mesh(n_rays=4)`, is a layout without process groups: the ray-sharded
factories' `local(..., rank)` functions run one rank's shard of it, so one
process can run every rank in turn.

Every all-gather here is an all_reduce-sum of a zeroed [size, ...] buffer
in which each rank fills its own slot: exact in float, and one code path
for every backend (gloo runs all_reduce on CUDA tensors, not all_gather).
The collectives that a gradient flows through are autograd Functions with
their transposes spelled out (`replicate`, `gather_blocks`, `sum_blocks`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

RAYS_AXIS = "rays"
SCENE_AXIS = "scene"


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_rays: int
    n_scene: int = 1
    rank: int = 0                       # this process's global rank
    rays_group: Optional[object] = None   # the ranks of this rank's column
    scene_group: Optional[object] = None  # the ranks of this rank's row

    def __post_init__(self):
        if self.n_rays < 1 or self.n_scene < 1:
            raise ValueError(f"mesh {self.n_rays}x{self.n_scene} is empty")

    @property
    def shape(self) -> dict:
        return {RAYS_AXIS: self.n_rays, SCENE_AXIS: self.n_scene}

    @property
    def size(self) -> int:
        return self.n_rays * self.n_scene

    @property
    def rays_index(self) -> int:
        return self.rank // self.n_scene

    @property
    def scene_index(self) -> int:
        return self.rank % self.n_scene

    def index(self, axis: str) -> int:
        return self.rays_index if axis == RAYS_AXIS else self.scene_index

    def group(self, axis: str):
        return self.rays_group if axis == RAYS_AXIS else self.scene_group


def make_mesh(n_rays: Optional[int] = None, n_scene: int = 1) -> Mesh:
    """The ("rays", "scene") mesh of the job's ranks; all of them on "rays"
    by default.  Every rank must call it (torch.distributed.new_group is
    collective).  Without an initialized process group the job is one
    rank: only a 1 x 1 mesh fits it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_rays is None:
        n_rays = world // n_scene
    need = n_rays * n_scene
    if need != world or need == 0:
        raise ValueError(f"mesh {n_rays}x{n_scene} needs {need} ranks; the job has {world}")
    rays_group = scene_group = None
    # every rank creates every group, in the same order
    for k in range(n_scene):
        ranks = [a * n_scene + k for a in range(n_rays)]
        g = dist.new_group(ranks) if n_rays > 1 else None
        if rank in ranks:
            rays_group = g
    for a in range(n_rays):
        ranks = [a * n_scene + k for k in range(n_scene)]
        g = dist.new_group(ranks) if n_scene > 1 else None
        if rank in ranks:
            scene_group = g
    return Mesh(n_rays=n_rays, n_scene=n_scene, rank=rank, rays_group=rays_group,
                scene_group=scene_group)


def _group_or_raise(mesh: Mesh, axis: str):
    g = mesh.group(axis)
    if g is None:
        raise RuntimeError(f"the mesh's {axis!r} axis has {mesh.shape[axis]} ranks and no "
                           "process group: build it with make_mesh() in every rank, or call "
                           "the factory's local(..., rank) for one rank at a time")
    return g


def axis_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of x over the ranks of this rank's group on axis (a new
    tensor; x itself on an axis of size 1)."""
    if mesh.shape[axis] == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=_group_or_raise(mesh, axis))
    return y


def axis_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[size, *x.shape]: x of every rank of the group on axis, in index
    order (an all_reduce-sum of a zeroed buffer, each rank in its slot)."""
    n = mesh.shape[axis]
    if n == 1:
        return x[None]
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[mesh.index(axis)] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=_group_or_raise(mesh, axis))
    return buf


def _flat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in xs])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    out, k = [], 0
    for x in like:
        out.append(flat[k:k + x.numel()].view_as(x))
        k += x.numel()
    return tuple(out)


class _Replicate(torch.autograd.Function):
    """Tensors replicated over an axis: the forward is the identity, the
    backward sums each rank's cotangents over the axis (one all_reduce of
    them all), so every rank holds the gradient of the global loss."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        summed = _unflat(axis_sum(_flat(gs), ctx.mesh, ctx.axis), gs)
        return (None, None) + summed


def replicate(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str = RAYS_AXIS):
    """xs as they are, replicated over axis: gradients flowing back into
    them are summed over the axis's ranks."""
    if mesh.shape[axis] == 1:
        return tuple(xs)
    return _Replicate.apply(mesh, axis, *xs)


class _GatherBlocks(torch.autograd.Function):
    """The blocks of every rank on an axis, concatenated along dim 0.  The
    cotangent of the whole is the same on every rank of the axis (each
    computes the same function of it), so the transpose is this rank's
    own block of it, not a sum over the ranks."""

    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis, ctx.n = mesh, axis, x.shape[0]
        g = axis_gather(x, mesh, axis)
        return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))

    @staticmethod
    def backward(ctx, g):
        me = ctx.mesh.index(ctx.axis)
        return None, None, g[me * ctx.n:(me + 1) * ctx.n]


def gather_blocks(x: torch.Tensor, mesh: Mesh, axis: str = SCENE_AXIS) -> torch.Tensor:
    """[size * n, ...]: the [n, ...] blocks of the axis's ranks, in order."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherBlocks.apply(mesh, axis, x)


class _SumBlocks(torch.autograd.Function):
    """A sum over an axis of terms of which one rank's is nonzero (the
    masked gather of the winner's parameters).  Every rank of the axis
    computes the same function of the sum, so each holds the whole
    cotangent: the transpose passes it through, no sum."""

    @staticmethod
    def forward(ctx, mesh, axis, x):
        return axis_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, g


def sum_blocks(x: torch.Tensor, mesh: Mesh, axis: str = SCENE_AXIS) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return x
    return _SumBlocks.apply(mesh, axis, x)
