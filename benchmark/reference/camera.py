"""The book's camera (Camera::initialize and get_ray) as plain PyTorch:
the 24-float row of derived geometry and the primary rays of (pixel, ray
id) pairs, drawn with the hash of draws.py.  The geometry is derived in
float32 on the CPU in the expression order of the renderer, so that its
rays agree with the program's to the bit, not only to rounding."""

from __future__ import annotations

import torch

from benchmark.reference.draws import CAM_DRAW0, hash_u01

CAM_ROW = 24


def image_size(cam: dict):
    """(width, height) of a configuration's camera entry."""
    w = int(cam["image_width"])
    return w, max(int(w / float(cam["aspect_ratio"])), 1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    n2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    inv = torch.where(n2 > 0.0, torch.rsqrt(torch.where(n2 > 0.0, n2, 1.0)), 0.0)
    return v * inv


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                        u[0] * v[1] - u[1] * v[0]])


def camera_row(cam: dict) -> torch.Tensor:
    """[24] float32 (CPU): center, pixel (0, 0), pixel steps u and v,
    defocus disk u and v, the defocus angle, five zeros."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    width, height = image_size(cam)
    vfov, lookfrom, lookat, vup = (f32(cam[k]) for k in ("vfov", "lookfrom", "lookat", "vup"))
    angle, focus = f32(cam["defocus_angle"]), f32(cam["focus_dist"])
    h = torch.tan(torch.deg2rad(vfov) / 2.0)
    vh = 2.0 * h * focus
    vw = vh * (width / height)
    w = _unit(lookfrom - lookat)
    u = _unit(_cross(vup, w))
    v = _cross(w, u)
    vu = vw * u
    vv = vh * (-v)
    du = vu / width
    dv = vv / height
    upper_left = lookfrom - focus * w - vu / 2.0 - vv / 2.0
    p00 = upper_left + 0.5 * (du + dv)
    radius = focus * torch.tan(torch.deg2rad(angle / 2.0))
    return torch.cat([lookfrom, p00, du, dv, u * radius, v * radius, angle.reshape(1),
                      torch.zeros(5)]).to(torch.float32)


def primary_rays(row: torch.Tensor, pix: torch.Tensor, rid: torch.Tensor, cam_seed: int,
                 width: int, dtype=torch.float32):
    """(o [R, 3], d [R, 3]) of pixels pix with ray ids rid (int64 [R]):
    jitter inside the pixel, a point of the defocus disk (sqrt-polar),
    unnormalized direction to the jittered pixel."""
    c = row.to(pix.device, dtype)
    jx, jy, u1, u2 = (hash_u01(rid, cam_seed, CAM_DRAW0 + k).to(dtype) for k in range(4))
    rr = torch.sqrt(u1)
    th = 6.2831853 * u2
    px, py = rr * torch.cos(th), rr * torch.sin(th)
    j = pix // width
    fi = (pix - j * width).to(dtype) + (jx - 0.5)
    fj = j.to(dtype) + (jy - 0.5)
    target = [c[3 + k] + fi * c[6 + k] + fj * c[9 + k] for k in range(3)]
    disk = c[18] > 0.0
    o = [torch.where(disk, c[k] + px * c[12 + k] + py * c[15 + k], c[k]) for k in range(3)]
    return (torch.stack(o, -1), torch.stack([target[k] - o[k] for k in range(3)], -1))
