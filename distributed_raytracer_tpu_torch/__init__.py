"""distributed_raytracer_tpu_torch — the PyTorch/CUDA port of the JAX
package distributed_raytracer_tpu (the reference it is tested against).

A package of its own beside the JAX one: it imports torch and numpy,
never JAX or the JAX package.  Plain tensor code is PyTorch; every TPU
kernel on a ported path is a CUDA kernel written for Hopper (sm_90a),
with a plain PyTorch version beside it that runs on CPU tensors.  Entry
points run on the CUDA card unless the caller asks for the CPU.  Scene
files are models/scene_io.py's; the distributed layer, on
torch.distributed, is the subpackage parallel/.
"""

from distributed_raytracer_tpu_torch.grad.diff_render import (
    CAMERA_POSE_FIELDS,
    InverseRenderer,
    image_loss,
    render_diff,
    scene_and_camera_grads,
    scene_grads,
)
from distributed_raytracer_tpu_torch.grad.pathgrad import make_image_grad_fn, make_pathgrad_tracer
from distributed_raytracer_tpu_torch.grad.tapegrad import (
    make_tape_camera_pose_tracer,
    make_tape_camera_tracer,
    make_tape_camera_walk_tracer,
    make_tape_tracer,
)
from distributed_raytracer_tpu_torch.models.scene import (
    ABSORB,
    DIELECTRIC,
    LAMBERTIAN,
    METAL,
    TRANSPARENT,
    Scene,
    SceneBuilder,
)
from distributed_raytracer_tpu_torch.models.scene_io import load_scene, save_scene
from distributed_raytracer_tpu_torch.ops.camera import Camera, make_camera
from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_kernel import (
    render_wavefront_sum_mega_walk,
)
from distributed_raytracer_tpu_torch.render.renderer import render_image, render_sample_batch
from distributed_raytracer_tpu_torch.render.wavefront import render_image_wavefront

__all__ = [
    "Scene",
    "SceneBuilder",
    "Camera",
    "make_camera",
    "load_scene",
    "save_scene",
    "make_tape_camera_tracer",
    "make_tape_camera_walk_tracer",
    "make_tape_tracer",
    "make_tape_camera_pose_tracer",
    "render_wavefront_sum_mega_walk",
    "render_image",
    "render_sample_batch",
    "render_image_wavefront",
    "image_loss",
    "render_diff",
    "scene_grads",
    "scene_and_camera_grads",
    "InverseRenderer",
    "CAMERA_POSE_FIELDS",
    "make_pathgrad_tracer",
    "make_image_grad_fn",
    "LAMBERTIAN",
    "METAL",
    "DIELECTRIC",
    "ABSORB",
    "TRANSPARENT",
]
