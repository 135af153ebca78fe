"""Joining a multi-process job: the port of distributed_raytracer_tpu/
parallel/multihost.py on torch.distributed.

Every process of a job runs the same command.  `initialize` joins the
process group (membership comes from the launcher's address, world size
and rank: nothing to discover); the scene is built on every rank and
`replicate_scene` makes every rank hold rank 0's arrays; each rank renders
its shard of the pixels, and `gather_image` brings the shards together in
rank order.  A single process is the degenerate case of the same code:
without an address nothing is initialized, and every collective on a
1 x 1 mesh is the identity.

The backend follows the device: NCCL for the card, gloo for the CPU.  One
card cannot hold two NCCL ranks, so several ranks on one card use gloo
(`backend="gloo"`), which reduces CUDA tensors too.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.parallel.mesh import RAYS_AXIS, Mesh, axis_gather

# seconds a collective may wait for the other ranks before it fails
TIMEOUT_S = 600


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               backend: Optional[str] = None) -> bool:
    """Join the job's process group; returns whether one is initialized.

    coordinator_address is HOST:PORT (a TCP rendezvous at rank 0) or an
    init_method URL (tcp://..., file://...).  Arguments not given come
    from torch's standard variables: MASTER_ADDR and MASTER_PORT, WORLD_SIZE
    and RANK.  With neither an address nor a process count, nothing is
    initialized (a single-process run).  backend: NCCL when device is a
    CUDA device (the default), gloo when it is the CPU."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process job needs the coordinator address, the number of "
                         "processes and this process's id (or MASTER_ADDR/MASTER_PORT, "
                         "WORLD_SIZE and RANK)")
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    url = coordinator_address if "://" in coordinator_address else (
        f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> dict:
    on = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
        "backend": dist.get_backend() if on else None,
        "local_devices": torch.cuda.device_count(),
    }


def replicate_scene(scene: Scene) -> Scene:
    """Every rank's scene becomes rank 0's: one broadcast per field into
    copies of the rank's own tensors, which must have rank 0's shapes.  A
    process that joined no group keeps its own."""
    if not dist.is_initialized():
        return scene
    out = {}
    for k, x in vars(scene).items():
        y = x.contiguous().clone()
        dist.broadcast(y, src=0)
        out[k] = y
    return Scene(**out)


def gather_image(partial: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rays shards of the rank's column, concatenated in rank order:
    [n_rays * s_loc, ...] from every rank's [s_loc, ...] partial sums (the
    ranks of a row hold the same rays, so one column has them all)."""
    g = axis_gather(partial.detach().contiguous(), mesh, RAYS_AXIS)
    return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))
