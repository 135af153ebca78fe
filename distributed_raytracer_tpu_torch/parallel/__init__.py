"""The distributed layer on torch.distributed: the mesh of ranks
(mesh.py), joining a job (multihost.py), ray/pixel data parallelism
(sharded.py), sphere-axis sharding (scene_sharded.py) and spatial scene
sharding (spatial.py)."""

from distributed_raytracer_tpu_torch.parallel.mesh import (  # noqa: F401
    RAYS_AXIS,
    SCENE_AXIS,
    Mesh,
    make_mesh,
    pad_to_multiple,
)
from distributed_raytracer_tpu_torch.parallel.scene_sharded import (  # noqa: F401
    closest_hit_sharded,
    make_scene_sharded_grad_fn,
    make_scene_sharded_render,
    make_tape_2d_tracer,
    shard_scene,
    trace_rays_sharded,
)
from distributed_raytracer_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedRenderer,
    make_fused_dp_render,
    make_mega_dp_render,
    make_mega_walk_dp_render,
    make_sharded_grad_fn,
    make_tape_camera_dp_tracer,
    make_tape_camera_walk_dp_tracer,
    make_tape_dp_tracer,
)
from distributed_raytracer_tpu_torch.parallel.spatial import shard_scene_spatial  # noqa: F401
