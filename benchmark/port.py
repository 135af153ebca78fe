"""The system under test, as the benchmark drives it: the entry points of
distributed_raytracer_tpu_torch that the cells' requests call, and the
conversion of the benchmark's inputs into the program's types.

Nothing else of the program is used.  The drivers call the program only
through this module's names, so a test can put a broken entry point in
its place (benchmark/faults.py).
"""

from __future__ import annotations

import re
from pathlib import Path

from distributed_raytracer_tpu_torch.grad.diff_render import image_loss
from distributed_raytracer_tpu_torch.grad.tapegrad import (
    make_tape_camera_tracer,
    make_tape_camera_walk_tracer,
)
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import make_camera
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import mega_render_supported
from distributed_raytracer_tpu_torch.render.progressive import render_progressive

PACKAGE = "distributed_raytracer_tpu_torch"
CSRC = Path(__file__).resolve().parents[1] / PACKAGE / "csrc"

__all__ = ["image_loss", "make_tape_camera_tracer", "make_tape_camera_walk_tracer",
           "render_progressive", "mega_render_supported", "scene", "camera", "kernel_names"]


def scene(arrays: dict) -> Scene:
    """The program's host scene from the benchmark's scene arrays."""
    return Scene.from_numpy(dict(centers=arrays["centers"], radii=arrays["radii"],
                                 albedo=arrays["albedo"], mat_type=arrays["mat"],
                                 fuzz=arrays["fuzz"], ior=arrays["ior"]), "cpu")


def camera(cam: dict, spp: int):
    """The program's host camera from a configuration's camera entry."""
    return make_camera(aspect_ratio=float(cam["aspect_ratio"]),
                       image_width=int(cam["image_width"]), samples_per_pixel=int(spp),
                       max_depth=int(cam["max_depth"]), vfov=float(cam["vfov"]),
                       lookfrom=tuple(map(float, cam["lookfrom"])),
                       lookat=tuple(map(float, cam["lookat"])),
                       vup=tuple(map(float, cam["vup"])),
                       defocus_angle=float(cam["defocus_angle"]),
                       focus_dist=float(cam["focus_dist"]))


def kernel_names() -> set:
    """The names of the program's hand-written CUDA kernels, read from its
    sources: what the trace's device events are matched against."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    return {m for f in CSRC.glob("*.cu*") for m in pat.findall(f.read_text())}
