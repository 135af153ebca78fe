"""The port imports no JAX and nothing of the JAX package."""

import pathlib
import subprocess
import sys

import pytest
import torch

from distributed_raytracer_tpu_torch import (
    make_tape_camera_pose_tracer,
    make_tape_camera_tracer,
    make_tape_tracer,
)
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.ops.camera import make_camera

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "distributed_raytracer_tpu_torch"
# names that must never be loaded by the port (exact module or its children)
FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_raytracer_tpu")


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax():
    mods = _modules()
    for m in ("cli", "grad.tapegrad", "grad.diff_render", "ops.kernels.local_f",
              "ops.kernels.mega_kernel", "ops.kernels.mega_walk_bwd_kernel", "native",
              "ops.kernels.culled_kernel", "ops.kernels.mega_walk_kernel",
              "ops.kernels.mega_bwd_kernel", "ops.kernels.bounce_kernel",
              "ops.kernels.culled_bounce_kernel", "render.order", "render.wavefront",
              "core.prng", "core.rng", "core.interval", "core.ray", "ops.intersect",
              "ops.materials", "ops.trace", "ops.kernels.intersect_kernel",
              "render.renderer", "grad.pathgrad", "render.progressive", "utils.config",
              "models.scene_io", "models.aabb", "parallel", "parallel.mesh",
              "parallel.multihost", "parallel.sharded", "parallel.scene_sharded",
              "parallel.spatial", "utils.metrics", "utils.sanitize", "utils.supervise",
              "render.display", "render.image"):
        assert f"distributed_raytracer_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("suffix", ["*.py", "*.cu", "*.cuh"])
def test_port_sources_name_no_jax_module(suffix):
    for p in PKG.rglob(suffix):
        text = p.read_text()
        assert "distributed_raytracer_tpu." not in text, p
        assert "import jax" not in text and "from jax" not in text, p


def test_tracer_defaults_to_the_card():
    """device=None means the CUDA card: without one the tracer refuses to
    run rather than carry on on the CPU."""
    camera = make_camera(image_width=4)
    if torch.cuda.is_available():
        make_tape_camera_tracer(camera, 1, 2)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_tape_camera_tracer(camera, 1, 2)


@pytest.mark.parametrize("factory", ["ray", "pose"])
def test_ray_and_pose_tracers_default_to_the_card(factory):
    camera = make_camera(image_width=4)
    make = ((lambda: make_tape_tracer(prng.PRNGKey(1), 2, use_mega=True, mega_bwd=True))
            if factory == "ray"
            else (lambda: make_tape_camera_pose_tracer(camera, 1, 2)))
    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.parametrize("entry", ["host_tape", "pathgrad", "image_grad", "scene_grads",
                                   "inverse"])
def test_gradient_entry_points_default_to_the_card(entry):
    import distributed_raytracer_tpu_torch as dt
    from distributed_raytracer_tpu_torch.models.presets import config1

    scene, _ = config1()
    camera = make_camera(image_width=4, max_depth=1)
    target = torch.zeros(camera.num_pixels, 3)
    make = {
        "host_tape": lambda: dt.make_tape_tracer(prng.PRNGKey(1), 2),
        "pathgrad": lambda: dt.make_pathgrad_tracer(prng.PRNGKey(1), 2),
        "image_grad": lambda: dt.make_image_grad_fn(camera),
        "scene_grads": lambda: dt.scene_grads(scene, camera, prng.PRNGKey(1), [0], target),
        "inverse": lambda: dt.InverseRenderer(scene, camera, target, engine="tape"),
    }[entry]
    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.parametrize("entry", ["render_image", "render_image_wavefront"])
def test_reference_engines_default_to_the_card(entry):
    import distributed_raytracer_tpu_torch as dt
    from distributed_raytracer_tpu_torch.models.presets import config1

    scene, camera = config1()
    camera = make_camera(image_width=4, max_depth=1)
    if torch.cuda.is_available():
        getattr(dt, entry)(scene, camera, spp=1)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(dt, entry)(scene, camera, spp=1)
