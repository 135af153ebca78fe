"""Worker of the port's multi-process gloo tests (test_torch_multihost.py).
It imports the port only, never JAX: it runs one task as one rank of a
torch.distributed job and saves what the parent compares.

Run: python _torch_multihost_worker.py TASK RANK WORLD INIT_FILE OUTDIR

Tasks:
  camera_step    one camera-dp training step (make_tape_camera_dp_tracer,
                 image loss over the whole image, backward) on a 2-rank mesh
  scene_sharded  the scene-sharded layer on a 2 x 2 mesh: closest_hit_sharded
                 (dense and through K11's plain version), gather_params_sharded,
                 make_scene_sharded_render, make_scene_sharded_grad_fn and
                 make_tape_2d_tracer
  k11_scene_shards  closest_hit_sharded with K11 over 2 scene blocks, on the
                 device named by a sixth argument (cuda: the card test of
                 test_torch_cuda.py)
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from distributed_raytracer_tpu_torch.core import prng  # noqa: E402
from distributed_raytracer_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from distributed_raytracer_tpu_torch.ops.camera import generate_rays, make_camera  # noqa: E402
from distributed_raytracer_tpu_torch.parallel import make_mesh, multihost  # noqa: E402

DIFF = ("centers", "radii", "albedo", "fuzz", "ior")


def parallel_scene():
    """tests/test_parallel.py's scene (five spheres, every material)."""
    return (SceneBuilder()
            .add_lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0))
            .add_lambertian((0, 0, -1.2), 0.5, (0.1, 0.2, 0.5))
            .add_metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.2)
            .add_dielectric((-1, 0, -1), 0.5, 1.5)
            .add_metal((0.3, -0.2, -0.8), 0.15, (0.9, 0.3, 0.3), 0.0)
            .build())


def camera(width):
    return make_camera(aspect_ratio=2.0, image_width=width, samples_per_pixel=4, max_depth=6)


def camera_step(out):
    from distributed_raytracer_tpu_torch.models.presets import final_scene_camera, rtiow_final_scene
    from distributed_raytracer_tpu_torch.parallel import make_tape_camera_dp_tracer

    scene = rtiow_final_scene(seed=0, pad_to=512)
    cam = final_scene_camera(31).replace(max_depth=5)
    n = cam.num_pixels
    target = torch.from_numpy(np.random.default_rng(2).random((n, 3)).astype(np.float32))
    mesh = make_mesh()
    dp = make_tape_camera_dp_tracer(mesh, cam, 7, 8, device="cpu")
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in DIFF}
    cols = dp(scene.with_diff_params(leaves))
    s_loc = cols.shape[0]
    tgt = torch.cat([target, torch.zeros(mesh.n_rays * s_loc - n, 3)])
    r = mesh.rays_index
    loss = ((cols - tgt[r * s_loc:(r + 1) * s_loc]) ** 2).sum() / (3.0 * n)
    loss.backward()
    full = multihost.gather_image(cols, mesh)[:n]
    np.savez(out, colors=full.numpy(), **{k: v.grad.numpy() for k, v in leaves.items()})


def scene_sharded(out):
    from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import closest_hit_pallas
    from distributed_raytracer_tpu_torch.parallel import (
        make_scene_sharded_grad_fn,
        make_scene_sharded_render,
        make_tape_2d_tracer,
        shard_scene,
    )
    from distributed_raytracer_tpu_torch.parallel.scene_sharded import (
        closest_hit_sharded,
        gather_params_sharded,
        scene_block,
    )

    mesh = make_mesh(n_rays=2, n_scene=2)
    padded = shard_scene(parallel_scene(), 2)
    block = scene_block(padded, mesh)
    res = {}
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.uniform(-3, 3, (64, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    for name, li in (("dense", None), ("k11", closest_hit_pallas)):
        h = closest_hit_sharded(o, d, block, mesh, li)
        res[f"hit_{name}_t"], res[f"hit_{name}_idx"] = h.t.numpy(), h.idx.numpy()
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, padded.num_spheres, 32))
    for k, v in gather_params_sharded(block, idx, mesh).items():
        res[f"params_{k}"] = v.numpy()

    cam = camera(31)  # 31x15: the rays axis's last shard is short
    n = cam.num_pixels
    ids = torch.cat([torch.arange(n), torch.zeros(1, dtype=torch.int64)])
    render = make_scene_sharded_render(mesh, cam, device="cpu")
    res["render"] = render(padded, prng.PRNGKey(7), [0, 1], ids).numpy()

    target = np.random.default_rng(3).random((n, 3)).astype(np.float32)
    loss, grads = make_scene_sharded_grad_fn(mesh, cam, device="cpu")(
        padded, prng.PRNGKey(3), [0], target)
    res["loss"] = np.float32(loss)
    res.update({f"grad_{k}": v.numpy() for k, v in grads.items()})

    cam32 = camera(32)
    ids = torch.arange(128)
    o, d = generate_rays(cam32, ids % 32, ids // 32, key=prng.PRNGKey(5))
    f2d = make_tape_2d_tracer(mesh, prng.PRNGKey(9), 6, pool=32, device="cpu")
    leaves = {k: getattr(padded, k).clone().requires_grad_() for k in DIFF}
    dd = d.clone().requires_grad_()
    cols = f2d(padded.with_diff_params(leaves), o, dd)
    (cols ** 2).sum().backward()
    res["tape_colors"] = cols.detach().numpy()
    res["tape_d"] = dd.grad.numpy()
    res.update({f"tape_{k}": v.grad.numpy() for k, v in leaves.items()})
    np.savez(out, **res)


def k11_rays(dev):
    """4,096 random rays over the final scene."""
    g = torch.Generator().manual_seed(4)
    o = torch.stack([torch.rand(4096, generator=g) * 24 - 12, torch.rand(4096, generator=g) * 3,
                     torch.rand(4096, generator=g) * 24 - 12], -1)
    d = torch.randn(4096, 3, generator=g)
    return o.to(dev).contiguous(), d.to(dev).contiguous()


def k11_scene_shards(out, dev):
    """closest_hit_sharded with K11 on each of 2 scene blocks."""
    from distributed_raytracer_tpu_torch.models.presets import rtiow_final_scene
    from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import (
        closest_hit_cuda,
        closest_hit_pallas,
    )
    from distributed_raytracer_tpu_torch.parallel import shard_scene
    from distributed_raytracer_tpu_torch.parallel.scene_sharded import (
        closest_hit_sharded,
        scene_block,
    )

    mesh = make_mesh(n_rays=1, n_scene=2)
    block = scene_block(shard_scene(rtiow_final_scene(pad_to=512).to(dev), 2), mesh)
    o, d = k11_rays(dev)
    before = closest_hit_cuda.launches
    hit = closest_hit_sharded(o, d, block, mesh, closest_hit_pallas)
    assert closest_hit_cuda.launches == before + (dev.type == "cuda")
    np.savez(out, t=hit.t.cpu().numpy(), idx=hit.idx.cpu().numpy())


def main():
    task, rank, world, init_file, outdir = sys.argv[1:6]
    dev = torch.device(sys.argv[6] if len(sys.argv) > 6 else "cpu")
    torch.set_num_threads(1)
    # gloo for every task: one card cannot hold two NCCL ranks
    multihost.initialize(f"file://{init_file}", int(world), int(rank), device=dev,
                         backend="gloo")
    try:
        out = os.path.join(outdir, f"{task}_{rank}.npz")
        if task == "k11_scene_shards":
            k11_scene_shards(out, dev)
        else:
            {"camera_step": camera_step, "scene_sharded": scene_sharded}[task](out)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
