"""Canonical scenes and camera configs, generated by the same seeded
numpy code as distributed_raytracer_tpu/models/presets.py, so each preset
is array-equal to the JAX package's."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from distributed_raytracer_tpu_torch.models.scene import Scene, SceneBuilder
from distributed_raytracer_tpu_torch.ops.camera import Camera, make_camera


def rtiow_final_scene(
    seed: int = 0, include_features: bool = True, pad_to: Optional[int] = None
) -> Scene:
    """The RTiOW final scene: ground sphere, ~400 random small spheres
    (80/15/5 Lambertian/metal/glass), three feature spheres.
    include_features=False omits the ground and feature spheres."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    if include_features:
        b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))

    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose_mat = rng.random()
            center = (
                a + 0.9 * rng.random(),
                0.2,
                bb + 0.9 * rng.random(),
            )
            # skip spheres near the big metal sphere's spot
            d = np.array(center) - np.array([4.0, 0.2, 0.0])
            if float(np.sqrt(np.sum(d * d))) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.random(3) * rng.random(3)
                b.add_lambertian(center, 0.2, albedo)
            elif choose_mat < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.uniform(0.0, 0.5)
                b.add_metal(center, 0.2, albedo, fuzz)
            else:
                b.add_dielectric(center, 0.2, 1.5)

    if include_features:
        b.add_dielectric((0.0, 1.0, 0.0), 1.0, 1.5)
        b.add_lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
        b.add_metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)

    return b.build(pad_to=pad_to)


def final_scene_camera(image_width: int = 1200, spp: int = 500) -> Camera:
    """The canonical workload camera: 16:9, depth 50, defocus 0.6."""
    return make_camera(
        aspect_ratio=16.0 / 9.0,
        image_width=image_width,
        samples_per_pixel=spp,
        max_depth=50,
        vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        defocus_angle=0.6,
        focus_dist=10.0,
    )


def random_sphere_field(
    n: int, seed: int = 0, extent: float = 50.0, pad_to: Optional[int] = None
) -> Scene:
    """A large random sphere field (same material mix as the RTiOW scene)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for _ in range(n):
        center = (
            rng.uniform(-extent, extent),
            rng.uniform(0.2, 3.0),
            rng.uniform(-extent, extent),
        )
        radius = rng.uniform(0.15, 0.5)
        choose = rng.random()
        if choose < 0.8:
            b.add_lambertian(center, radius, rng.random(3) * rng.random(3))
        elif choose < 0.95:
            b.add_metal(center, radius, rng.uniform(0.5, 1.0, 3), rng.uniform(0, 0.5))
        else:
            b.add_dielectric(center, radius, 1.5)
    return b.build(pad_to=pad_to)


def config1() -> Tuple[Scene, Camera]:
    """Single Lambertian sphere + ground, 400x225 @ 10 spp, depth 8."""
    scene = (
        SceneBuilder()
        .add_lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0))
        .add_lambertian((0.0, 0.0, -1.0), 0.5, (0.1, 0.2, 0.5))
        .build()
    )
    cam = make_camera(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=10, max_depth=8
    )
    return scene, cam


def config2() -> Tuple[Scene, Camera]:
    """Three-sphere Lambertian/metal/dielectric, 400x225 @ 100 spp, depth 50."""
    scene = (
        SceneBuilder()
        .add_lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0))
        .add_lambertian((0.0, 0.0, -1.2), 0.5, (0.1, 0.2, 0.5))
        .add_dielectric((-1.0, 0.0, -1.0), 0.5, 1.5)
        .add_metal((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.3)
        .build()
    )
    cam = make_camera(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100, max_depth=50
    )
    return scene, cam


def config3() -> Tuple[Scene, Camera]:
    """Defocus-blur camera + hollow glass sphere, 800x450 @ 100 spp."""
    scene = (
        SceneBuilder()
        .add_lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0))
        .add_lambertian((0.0, 0.0, -1.2), 0.5, (0.1, 0.2, 0.5))
        .add_dielectric((-1.0, 0.0, -1.0), 0.5, 1.5)
        # hollow interior: air bubble via inverted-IOR inner sphere
        .add_dielectric((-1.0, 0.0, -1.0), 0.4, 1.0 / 1.5)
        .add_metal((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 1.0)
        .build()
    )
    cam = make_camera(
        aspect_ratio=16.0 / 9.0,
        image_width=800,
        samples_per_pixel=100,
        max_depth=50,
        vfov=20.0,
        lookfrom=(-2.0, 2.0, 1.0),
        lookat=(0.0, 0.0, -1.0),
        vup=(0.0, 1.0, 0.0),
        defocus_angle=10.0,
        focus_dist=3.4,
    )
    return scene, cam


def config4(seed: int = 0) -> Tuple[Scene, Camera]:
    """RTiOW final scene, 1200x675 @ 500 spp — the canonical workload."""
    return rtiow_final_scene(seed=seed), final_scene_camera()


def config5(seed: int = 0) -> Tuple[Scene, Camera]:
    """The final scene padded to 512 spheres (one sweep chunk)."""
    return rtiow_final_scene(seed=seed, pad_to=512), final_scene_camera()


CONFIGS = {
    "config1": config1,
    "config2": config2,
    "config3": config3,
    "config4": config4,
    "config5": config5,
}


def get_config(name: str) -> Tuple[Scene, Camera]:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]()
