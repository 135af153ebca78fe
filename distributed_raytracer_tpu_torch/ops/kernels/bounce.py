"""One bounce in plain PyTorch: the closest-hit sweep and the shading.

Plain versions of distributed_raytracer_tpu/ops/pallas/bounce_kernel.py::
_sweep_winner (:93) and ::_shade_vals (:150), in the same expression
order.  The CUDA device functions are csrc/bounce.cuh.  Every function
works on [R] ray rows; the sweep is a dense [R, N] quadratic.
"""

from __future__ import annotations

from typing import Tuple

import torch

from distributed_raytracer_tpu_torch.core.vecmath import BIG, NEAR_ZERO_EPS, T_MIN
from distributed_raytracer_tpu_torch.models.scene import (
    ABSORB,
    DIELECTRIC,
    LAMBERTIAN,
    METAL,
    TRANSPARENT,
    Scene,
)

SKY_TOP = (0.5, 0.7, 1.0)

# winner-attribute rows (the JAX kernels' _A_* layout)
A_CX, A_CY, A_CZ, A_RR = 0, 1, 2, 3
A_AR, A_AG, A_AB, A_FZ, A_IO, A_MT, A_IDX = 4, 5, 6, 7, 8, 9, 10
A_ROWS = 11


def scene_sweep_arrays(scene: Scene) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cols [4, N], attrs [11, N]) f32 on the scene's device.  cols are
    the sweep columns cx, cy, cz, r2 with r2 = -1 for radius <= 0 (so
    padding never hits); attrs are the winner attributes in A_* order."""
    r = scene.radii
    r2 = torch.where(r > 0.0, r * r, torch.full_like(r, -1.0))
    c = scene.centers
    cols = torch.stack([c[:, 0], c[:, 1], c[:, 2], r2])
    attrs = torch.stack(
        [c[:, 0], c[:, 1], c[:, 2], r,
         scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
         scene.fuzz, scene.ior, scene.mat_type.to(torch.float32),
         torch.arange(scene.num_spheres, dtype=torch.float32, device=c.device)]
    )
    return cols.contiguous(), attrs.contiguous()


def sweep_t(ox, oy, oz, dx, dy, dz, a, inv_a, cols):
    """Each ray's hit t on each sphere, [R, N] (BIG where it misses), in
    the kernel's oc-form arithmetic (near-then-far roots against T_MIN),
    and the [R, N] mask of the tests whose discriminant is not negative."""
    cx, cy, cz, r2 = (cols[k][None, :] for k in range(4))
    ocx = cx - ox[:, None]
    ocy = cy - oy[:, None]
    ocz = cz - oz[:, None]
    h = dx[:, None] * ocx + dy[:, None] * ocy + dz[:, None] * ocz
    c_q = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = h * h - a[:, None] * c_q
    ok = disc >= 0.0
    sqrtd = torch.sqrt(torch.where(ok, disc, 0.0))
    inv = inv_a[:, None]
    rn = (h - sqrtd) * inv
    rf = (h + sqrtd) * inv
    t = torch.where(ok & (rn > T_MIN), rn, torch.where(ok & (rf > T_MIN), rf, BIG))
    return t, ok


def sweep_winner(ox, oy, oz, dx, dy, dz, a, inv_a, cols, attrs):
    """Closest hit of each ray over all spheres (sweep_t), first minimum
    wins.  Returns (t_c [R], w [11, R]): the winner's t (BIG on a miss)
    and its attributes (zeros on a miss, as the JAX kernel's one-hot
    select)."""
    t, _ = sweep_t(ox, oy, oz, dx, dy, dz, a, inv_a, cols)
    return winner_of(t, attrs)


def winner_of(t, attrs):
    """(t_c [R], w [11, R]) from the [R, N] hit ts: the first minimum."""
    t_c, idx = torch.min(t, dim=1)  # first index of the minimum
    hit = t_c < BIG * 0.5
    w = torch.where(hit[None, :], attrs[:, idx], 0.0)
    return t_c, w


def shade_vals(ox, oy, oz, dx, dy, dz, a, act, t_best, w, draws):
    """Shading against the winner attributes w [>= 11, R] with the five
    draws (u1, u2, u3, u4, u_choice): surface geometry, Lambertian/metal/
    dielectric scatter, absorb/transparent handling, sky for misses.
    Returns the JAX function's 18 rows: (no_x, no_y, no_z, nd_x, nd_y,
    nd_z, at_r, at_g, at_b, co_r, co_g, co_b, fin_i32, idx_i32, rux, ruy,
    ruz, u_choice)."""
    hit = (t_best < BIG * 0.5) & act
    th = torch.where(hit, t_best, 1.0)

    wcx, wcy, wcz, wrr = w[A_CX], w[A_CY], w[A_CZ], w[A_RR]
    war, wag, wab = w[A_AR], w[A_AG], w[A_AB]
    wfz, wio = w[A_FZ], w[A_IO]
    idx_row = w[A_IDX].to(torch.int32)

    px = ox + th * dx
    py = oy + th * dy
    pz = oz + th * dz
    saferr = torch.where(wrr > 0.0, wrr, 1.0)
    nx = (px - wcx) / saferr
    ny = (py - wcy) / saferr
    nz = (pz - wcz) / saferr
    d_dot_n = dx * nx + dy * ny + dz * nz
    front = d_dot_n < 0.0
    fs = torch.where(front, 1.0, -1.0).to(dx.dtype)
    nx, ny, nz = nx * fs, ny * fs, nz * fs

    # gaussians via Box-Muller -> random unit vector
    u1, u2, u3, u4, u_choice = draws
    rad1 = torch.sqrt(-2.0 * torch.log(u1))
    g1 = rad1 * torch.cos(6.2831853 * u2)
    g2 = rad1 * torch.sin(6.2831853 * u2)
    g3 = torch.sqrt(-2.0 * torch.log(u3)) * torch.cos(6.2831853 * u4)
    gn = torch.rsqrt(g1 * g1 + g2 * g2 + g3 * g3 + 1e-20)
    rux, ruy, ruz = g1 * gn, g2 * gn, g3 * gn

    # Lambertian
    lx, ly, lz = nx + rux, ny + ruy, nz + ruz
    near0 = ((torch.abs(lx) < NEAR_ZERO_EPS) & (torch.abs(ly) < NEAR_ZERO_EPS)
             & (torch.abs(lz) < NEAR_ZERO_EPS))
    lx = torch.where(near0, nx, lx)
    ly = torch.where(near0, ny, ly)
    lz = torch.where(near0, nz, lz)

    # Metal: reflect about the oriented normal, then fuzz
    rx = dx - 2.0 * d_dot_n * fs * nx
    ry = dy - 2.0 * d_dot_n * fs * ny
    rz = dz - 2.0 * d_dot_n * fs * nz
    rinv = torch.rsqrt(rx * rx + ry * ry + rz * rz + 1e-20)
    mx = rx * rinv + wfz * rux
    my = ry * rinv + wfz * ruy
    mz = rz * rinv + wfz * ruz
    metal_ok = (mx * nx + my * ny + mz * nz) > 0.0

    # Dielectric: Schlick reflectance, total internal reflection
    ior = torch.where(wio > 0.0, wio, 1.0)
    ri = torch.where(front, 1.0 / ior, ior)
    dinv = torch.rsqrt(a)
    ux, uy, uz = dx * dinv, dy * dinv, dz * dinv
    cos_t = torch.clamp_max(-(ux * nx + uy * ny + uz * nz), 1.0)
    sin2 = torch.clamp_min(1.0 - cos_t * cos_t, 0.0)
    cannot = ri * ri * sin2 > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_m_cos = 1.0 - cos_t
    schlick = r0 + (1.0 - r0) * one_m_cos * one_m_cos * one_m_cos * one_m_cos * one_m_cos
    choose_refl = cannot | (schlick > u_choice)
    perp_x = ri * (ux + cos_t * nx)
    perp_y = ri * (uy + cos_t * ny)
    perp_z = ri * (uz + cos_t * nz)
    k = torch.abs(1.0 - (perp_x * perp_x + perp_y * perp_y + perp_z * perp_z))
    para = -torch.sqrt(k)
    fx = perp_x + para * nx
    fy = perp_y + para * ny
    fz2 = perp_z + para * nz
    u_dot_n = ux * nx + uy * ny + uz * nz
    gx = ux - 2.0 * u_dot_n * nx
    gy = uy - 2.0 * u_dot_n * ny
    gz = uz - 2.0 * u_dot_n * nz
    dielx = torch.where(choose_refl, gx, fx)
    diely = torch.where(choose_refl, gy, fy)
    dielz = torch.where(choose_refl, gz, fz2)

    mt = w[A_MT]  # material code as f32 (exact small ints)
    is_lam = mt == LAMBERTIAN
    is_met = mt == METAL
    is_die = mt == DIELECTRIC
    is_tra = mt == TRANSPARENT
    is_abs = mt == ABSORB

    def pick(lam, met, die, other):
        return torch.where(is_lam, lam, torch.where(is_met, met, torch.where(is_die, die, other)))

    ndx, ndy, ndz = pick(lx, mx, dielx, dx), pick(ly, my, diely, dy), pick(lz, mz, dielz, dz)
    white = is_die | is_tra
    attr = torch.where(white, 1.0, war)
    attg = torch.where(white, 1.0, wag)
    attb = torch.where(white, 1.0, wab)
    scattered = (~is_abs) & (metal_ok | ~is_met)

    # transparent keeps the original origin
    nox = torch.where(is_tra, ox, px)
    noy = torch.where(is_tra, oy, py)
    noz = torch.where(is_tra, oz, pz)

    # sky for misses
    uy_n = dy * dinv
    sky_a = 0.5 * (uy_n + 1.0)
    sky = [(1.0 - sky_a) + sky_a * top for top in SKY_TOP]

    keep = act & hit & scattered
    miss = act & ~hit
    co_r, co_g, co_b = (torch.where(miss, s, 0.0) for s in sky)
    return (
        torch.where(keep, nox, ox), torch.where(keep, noy, oy),
        torch.where(keep, noz, oz),
        torch.where(keep, ndx, dx), torch.where(keep, ndy, dy),
        torch.where(keep, ndz, dz),
        torch.where(keep, attr, 1.0), torch.where(keep, attg, 1.0),
        torch.where(keep, attb, 1.0),
        co_r, co_g, co_b,
        (act & ~keep).to(torch.int32), idx_row,
        rux, ruy, ruz, u_choice,
    )
