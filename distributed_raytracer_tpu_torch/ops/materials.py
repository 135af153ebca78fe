"""Batched material scattering, a select over the material codes: the
port of distributed_raytracer_tpu/ops/materials.py.

Every scatter mode is computed for every ray and the hit sphere's code
selects one (Lambertian, metal with fuzz and below-surface absorb,
dielectric with Schlick reflectance and total internal reflection,
absorbing, transparent), in JAX's expression order.  The draws are JAX's:
split(key) gives (k_unit, k_choice), the unit vector [R, 3] from k_unit
and the dielectric's uniform [R] from k_choice; `draws=` hands them in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core import rng as drng
from distributed_raytracer_tpu_torch.core import vecmath as vm
from distributed_raytracer_tpu_torch.models.scene import (
    ABSORB,
    DIELECTRIC,
    LAMBERTIAN,
    METAL,
    TRANSPARENT,
    Scene,
)


class ScatterResult(NamedTuple):
    origin: torch.Tensor       # [R, 3] scatter origin (the hit point)
    direction: torch.Tensor    # [R, 3] scattered direction
    attenuation: torch.Tensor  # [R, 3] this bounce's attenuation
    scattered: torch.Tensor    # [R] bool, False: absorbed


def surface_geometry(ray_o, ray_d, t, centers, radii):
    """Hit point, the normal against the ray and the face flag, from the
    winning spheres' gathered centers [R, 3] and radii [R]."""
    p = ray_o + t[:, None] * ray_d
    safe_r = torch.where(radii > 0.0, radii, 1.0)
    outward = (p - centers) / safe_r[:, None]
    front_face = vm.dot(ray_d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return p, normal, front_face


def gather_hit_params(scene: Scene, sphere_idx: torch.Tensor) -> dict:
    """The winning spheres' attributes, a dict of [R, ...] tensors."""
    i = sphere_idx.long()
    return dict(centers=scene.centers[i], radii=scene.radii[i], albedo=scene.albedo[i],
                mat=scene.mat_type[i], fuzz=scene.fuzz[i], ior=scene.ior[i])


def scatter(key: Optional[torch.Tensor], ray_o, ray_d, t, sphere_idx, scene: Scene,
            draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            row0: int = 0) -> ScatterResult:
    """One scatter event for rays that hit sphere_idx at t."""
    return scatter_gathered(key, ray_o, ray_d, t, gather_hit_params(scene, sphere_idx),
                            draws=draws, row0=row0)


def scatter_gathered(key: Optional[torch.Tensor], ray_o, ray_d, t, params: dict,
                     draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     row0: int = 0) -> ScatterResult:
    """scatter() with the winning spheres' attributes already gathered.
    draws: (unit vectors [R, 3], uniforms [R]) instead of the key's.
    row0: the rays are rows row0.. of a larger wavefront and take its
    draws (core/rng.py)."""
    r = ray_o.shape[0]
    centers, radii, albedo = params["centers"], params["radii"], params["albedo"]
    mat, fuzz, ior = params["mat"], params["fuzz"], params["ior"]

    p, normal, front_face = surface_geometry(ray_o, ray_d, t, centers, radii)

    if draws is None:
        k_unit, k_choice = prng.split(key)
        ruv = drng.unit_vector(k_unit, r, device=ray_o.device, row0=row0)
        u_choice = drng.uniform(k_choice, r, device=ray_o.device, row0=row0)
    else:
        ruv, u_choice = draws

    # Lambertian
    lam_dir = normal + ruv
    lam_dir = torch.where(vm.near_zero(lam_dir)[:, None], normal, lam_dir)

    # metal
    reflected = vm.unit_vector(vm.reflect(ray_d, normal))
    metal_dir = reflected + fuzz[:, None] * ruv
    metal_ok = vm.dot(metal_dir, normal) > 0.0

    # dielectric
    ri = torch.where(front_face, 1.0 / ior, ior)
    unit_d = vm.unit_vector(ray_d)
    cos_theta = torch.clamp_max(vm.dot(-unit_d, normal), 1.0)
    sin2 = 1.0 - cos_theta * cos_theta
    safe_sin2 = torch.where(sin2 > 0.0, sin2, 1.0)
    sin_theta = torch.where(sin2 > 0.0, torch.sqrt(safe_sin2), 0.0)
    cannot_refract = ri * sin_theta > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    x = 1.0 - cos_theta
    x2 = x * x
    reflectance = r0 + (1.0 - r0) * (x * (x2 * x2))  # x**5 as XLA's integer_pow
    choose_reflect = cannot_refract | (reflectance > u_choice)
    diel_dir = torch.where(choose_reflect[:, None], vm.reflect(unit_d, normal),
                           vm.refract(unit_d, normal, ri))

    is_lam = mat == LAMBERTIAN
    is_metal = mat == METAL
    is_diel = mat == DIELECTRIC
    is_transparent = mat == TRANSPARENT
    is_absorb = mat == ABSORB

    direction = torch.where(
        is_lam[:, None], lam_dir,
        torch.where(is_metal[:, None], metal_dir,
                    torch.where(is_diel[:, None], diel_dir, ray_d)))
    attenuation = torch.where((is_diel | is_transparent)[:, None], 1.0, albedo)
    scattered = ~is_absorb & (metal_ok | ~is_metal)
    # transparent keeps the ray's own origin
    origin = torch.where(is_transparent[:, None], ray_o, p)
    return ScatterResult(origin=origin, direction=direction, attenuation=attenuation,
                         scattered=scattered)
