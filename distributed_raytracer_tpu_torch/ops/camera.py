"""Camera model and batched primary-ray generation: the port of
distributed_raytracer_tpu/ops/camera.py (derived geometry in float32 with
the same expression order) plus the 24-float camera row that the render
kernel reads."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core import rng as drng
from distributed_raytracer_tpu_torch.core import vecmath as vm

_POSE = ("vfov", "lookfrom", "lookat", "vup", "defocus_angle", "focus_dist")
_DERIVED = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v",
            "u", "v", "w", "defocus_disk_u", "defocus_disk_v")
_STATIC = ("image_width", "image_height", "samples_per_pixel", "max_depth")

# camera-row layout: center, pixel00, delta_u, delta_v, disk_u, disk_v at
# these offsets (3 floats each), the defocus angle at _C_ANG, 5 pad floats
_C_CTR, _C_P00, _C_PDU, _C_PDV, _C_DDU, _C_DDV, _C_ANG = 0, 3, 6, 9, 12, 15, 18
CAM_ROW = 24


@dataclasses.dataclass(frozen=True)
class Camera:
    # static config
    image_width: int
    image_height: int
    samples_per_pixel: int
    max_depth: int
    # pose/optics (scalars are 0-d tensors, vectors [3]), all f32
    vfov: torch.Tensor
    lookfrom: torch.Tensor
    lookat: torch.Tensor
    vup: torch.Tensor
    defocus_angle: torch.Tensor
    focus_dist: torch.Tensor
    # derived from the pose (Camera::initialize)
    center: torch.Tensor
    pixel00_loc: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    defocus_disk_u: torch.Tensor
    defocus_disk_v: torch.Tensor

    @property
    def num_pixels(self) -> int:
        return self.image_width * self.image_height

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device: Union[str, torch.device]) -> "Camera":
        return self.replace(
            **{k: getattr(self, k).to(device) for k in _POSE + _DERIVED})

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray],
                   device: Union[str, torch.device]) -> "Camera":
        """A camera from its fields as numpy (e.g. `{f.name: np.asarray(
        getattr(cam, f.name))}` over the JAX Camera's fields): the four
        static ints plus the pose and derived arrays, taken as they are."""
        kw = {k: int(np.asarray(arrays[k])) for k in _STATIC}
        for k in _POSE + _DERIVED:
            kw[k] = torch.tensor(np.asarray(arrays[k]), dtype=torch.float32, device=device)
        return cls(**kw)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        out = {k: np.asarray(getattr(self, k)) for k in _STATIC}
        out.update({k: getattr(self, k).detach().cpu().numpy()
                    for k in _POSE + _DERIVED})
        return out


def derive(image_width: int, image_height: int, vfov, lookfrom, lookat, vup,
           defocus_angle, focus_dist) -> Dict[str, torch.Tensor]:
    """Camera::initialize's derived geometry, in float32."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    vfov, lookfrom, lookat, vup = f32(vfov), f32(lookfrom), f32(lookat), f32(vup)
    defocus_angle, focus_dist = f32(defocus_angle), f32(focus_dist)

    center = lookfrom
    h = torch.tan(torch.deg2rad(vfov) / 2.0)
    viewport_height = 2.0 * h * focus_dist
    viewport_width = viewport_height * (image_width / image_height)

    w = vm.unit_vector(lookfrom - lookat)
    u = vm.unit_vector(vm.cross(vup, w))
    v = vm.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = viewport_height * (-v)
    pixel_delta_u = viewport_u / image_width
    pixel_delta_v = viewport_v / image_height

    viewport_upper_left = center - focus_dist * w - viewport_u / 2.0 - viewport_v / 2.0
    pixel00_loc = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = focus_dist * torch.tan(torch.deg2rad(defocus_angle / 2.0))
    return dict(
        vfov=vfov, lookfrom=lookfrom, lookat=lookat, vup=vup,
        defocus_angle=defocus_angle, focus_dist=focus_dist,
        center=center, pixel00_loc=pixel00_loc,
        pixel_delta_u=pixel_delta_u, pixel_delta_v=pixel_delta_v,
        u=u, v=v, w=w,
        defocus_disk_u=u * defocus_radius, defocus_disk_v=v * defocus_radius,
    )


def make_camera(
    aspect_ratio: float = 1.0,
    image_width: int = 100,
    samples_per_pixel: int = 10,
    max_depth: int = 10,
    vfov: float = 90.0,
    lookfrom=(0.0, 0.0, 0.0),
    lookat=(0.0, 0.0, -1.0),
    vup=(0.0, 1.0, 0.0),
    defocus_angle: float = 0.0,
    focus_dist: float = 10.0,
) -> Camera:
    """An initialized CPU camera; defaults match Camera::new."""
    image_height = max(int(image_width / aspect_ratio), 1)
    d = derive(image_width, image_height, vfov, lookfrom, lookat, vup,
               defocus_angle, focus_dist)
    return Camera(image_width=image_width, image_height=image_height,
                  samples_per_pixel=samples_per_pixel, max_depth=max_depth, **d)


def reinitialize(camera: Camera) -> Camera:
    """Recompute the derived geometry after the pose fields changed."""
    d = derive(camera.image_width, camera.image_height,
               *(getattr(camera, k) for k in _POSE))
    return camera.replace(**d)


def camera_scalar_row(camera: Camera) -> torch.Tensor:
    """The [24] f32 camera row the render kernel reads (the JAX kernel's
    (1, 24) SMEM row, mega_render_kernel.py:339-353)."""
    dev = camera.center.device
    return torch.cat(
        [camera.center.reshape(3), camera.pixel00_loc.reshape(3),
         camera.pixel_delta_u.reshape(3), camera.pixel_delta_v.reshape(3),
         camera.defocus_disk_u.reshape(3), camera.defocus_disk_v.reshape(3),
         camera.defocus_angle.reshape(1),
         torch.zeros(5, dtype=torch.float32, device=dev)]
    ).to(torch.float32)


def rays_from_row(cam_row: torch.Tensor, pixel_i: torch.Tensor,
                  pixel_j: torch.Tensor, draws) -> Tuple[torch.Tensor, ...]:
    """Camera::get_ray on [R] rows from the 24-float camera row: pixel
    jitter (jx, jy) and the sqrt-polar defocus-disk sample (u1, u2).
    Returns (ox, oy, oz, dx, dy, dz); directions are not normalized.
    Tensor operations throughout, so the rays are differentiable in
    cam_row (the disk rows get zero cotangents without defocus, as the
    where passes none), and nothing is read back to the host."""
    jx, jy, u1, u2 = draws
    rr = torch.sqrt(u1)
    th = 6.2831853 * u2
    return rays_from_offsets(cam_row, pixel_i, pixel_j, jx - 0.5, jy - 0.5,
                             rr * torch.cos(th), rr * torch.sin(th))


def rays_from_offsets(cam_row: torch.Tensor, pixel_i: torch.Tensor, pixel_j: torch.Tensor,
                      off_x, off_y, p_x, p_y) -> Tuple[torch.Tensor, ...]:
    """rays_from_row from the pixel offsets (off_x, off_y) in [-0.5, 0.5)
    and the unit-disk point (p_x, p_y), each [R]."""
    c = cam_row
    fi = pixel_i.to(torch.float32) + off_x
    fj = pixel_j.to(torch.float32) + off_y
    ps = [c[_C_P00 + k] + fi * c[_C_PDU + k] + fj * c[_C_PDV + k] for k in range(3)]
    use_disk = c[_C_ANG] > 0.0
    o = [torch.where(use_disk, c[_C_CTR + k] + p_x * c[_C_DDU + k] + p_y * c[_C_DDV + k],
                     c[_C_CTR + k]) for k in range(3)]
    return (o[0], o[1], o[2], ps[0] - o[0], ps[1] - o[1], ps[2] - o[2])


def generate_rays(camera: Camera, pixel_i: torch.Tensor, pixel_j: torch.Tensor,
                  draws=None, *, key: Optional[torch.Tensor] = None, row0: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Camera::get_ray; pixel_i is the column, pixel_j the row.
    Returns (origins [R, 3], directions [R, 3]).  The draws are the given
    uniforms (jx, jy, u1, u2), each [R], or else JAX's threefry draws
    from key: split(key) gives (k_jitter, k_disk), square_jitter(k_jitter,
    R) the pixel offsets and in_unit_disk(k_disk, R) the disk point; with
    row0 the rays are rows row0.. of a larger batch and take its draws."""
    cam_row = camera_scalar_row(camera)
    if draws is not None:
        ox, oy, oz, dx, dy, dz = rays_from_row(cam_row, pixel_i, pixel_j, draws)
    else:
        r = pixel_i.shape[0]
        k_jitter, k_disk = prng.split(key)
        offset = drng.square_jitter(k_jitter, r, device=pixel_i.device, row0=row0)
        p = drng.in_unit_disk(k_disk, r, device=pixel_i.device, row0=row0)
        ox, oy, oz, dx, dy, dz = rays_from_offsets(cam_row, pixel_i, pixel_j, offset[:, 0],
                                                   offset[:, 1], p[:, 0], p[:, 1])
    return torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1)
