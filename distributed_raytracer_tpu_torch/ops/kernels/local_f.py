"""The replay bounce that scene gradients are defined by, in plain PyTorch.

Port of distributed_raytracer_tpu/ops/pallas/mega_bwd_kernel.py::
_local_f_rows (:72-212): one differentiable bounce from the winner's
parameters and the recorded draws, every operation in the JAX order, so
torch autograd of this function is the VJP the backward kernel
(csrc/local_f.cuh inside csrc/mega_walk_bwd.cu) computes.

This is the *replay* bounce, not `shade_vals`: the two differ in the
dielectric and guard details (`ri * sin_t > 1` against `ri*ri*sin2 > 1`,
`rsqrt` of a guarded norm against `rsqrt(x + 1e-20)`).  The forward
kernels shade with `shade_vals`; gradients differentiate this function,
as in the JAX package.
"""

from __future__ import annotations

import torch

from distributed_raytracer_tpu_torch.core.vecmath import NEAR_ZERO_EPS, T_MIN
from distributed_raytracer_tpu_torch.models.scene import (
    ABSORB,
    DIELECTRIC,
    LAMBERTIAN,
    METAL,
    TRANSPARENT,
)

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


def _pow5(x: torch.Tensor) -> torch.Tensor:
    """x ** 5 as XLA's integer_pow multiplies it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def _min1(x: torch.Tensor) -> torch.Tensor:
    """min(x, 1) with jnp.minimum's tie rule: half the tangent to each side."""
    return torch.minimum(x, x.new_ones(()))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's derivative at 0 (+1, where torch.abs gives 0)."""
    return torch.where(x >= 0.0, x, -x)


def _unit3(vx, vy, vz):
    """vecmath.unit_vector's guarded form (double where, rsqrt)."""
    n2 = vx * vx + vy * vy + vz * vz
    pos = n2 > 0.0
    inv = torch.where(pos, torch.rsqrt(torch.where(pos, n2, 1.0)), 0.0)
    return vx * inv, vy * inv, vz * inv


def local_f_rows(ox, oy, oz, dx, dy, dz, ar, ag, ab,
                 cwx, cwy, cwz, rw, awr, awg, awb, fw, iw,
                 mt, rux, ruy, ruz, u, hit, act):
    """One replay bounce on [R] rows.  mt is the material code as f32;
    hit and act are bool rows (not differentiated).  The guards that the
    backward applies before the call (mega_walk_bwd_kernel.py:124,129)
    are applied here: a row that hit nothing gets radius and ior 1.
    Returns the 12 rows (o2x..z, d2x..z, at2r..b, c2r..b)."""
    rw = torch.where(hit, rw, 1.0)
    iw = torch.where(hit, iw, 1.0)

    # ---- the winner's t (intersect_kernel.py:157-170), componentwise ----
    ocx = cwx - ox
    ocy = cwy - oy
    ocz = cwz - oz
    a = dx * dx + dy * dy + dz * dz
    h = dx * ocx + dy * ocy + dz * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rw * rw
    disc = h * h - a * c
    dpos = disc > 0.0
    safe = torch.where(dpos, disc, 1.0)
    sqrtd = torch.where(dpos, torch.sqrt(safe), 0.0)
    root_near = (h - sqrtd) / a
    root_far = (h + sqrtd) / a
    near_ok = (disc >= 0.0) & (root_near > T_MIN)
    t = torch.where(near_ok, root_near, root_far)
    th = torch.where(hit, t, 1.0)

    # ---- surface geometry ----
    px = ox + th * dx
    py = oy + th * dy
    pz = oz + th * dz
    safe_r = torch.where(rw > 0.0, rw, 1.0)
    owx = (px - cwx) / safe_r
    owy = (py - cwy) / safe_r
    owz = (pz - cwz) / safe_r
    front = (dx * owx + dy * owy + dz * owz) < 0.0
    fs = torch.where(front, 1.0, -1.0).to(ox.dtype)
    nx, ny, nz = owx * fs, owy * fs, owz * fs

    # ---- Lambertian ----
    lx, ly, lz = nx + rux, ny + ruy, nz + ruz
    near0 = ((torch.abs(lx) < NEAR_ZERO_EPS) & (torch.abs(ly) < NEAR_ZERO_EPS)
             & (torch.abs(lz) < NEAR_ZERO_EPS))
    lx = torch.where(near0, nx, lx)
    ly = torch.where(near0, ny, ly)
    lz = torch.where(near0, nz, lz)

    # ---- Metal: reflect about the oriented normal, normalize, fuzz ----
    d_dot_n = dx * nx + dy * ny + dz * nz
    rfx = dx - 2.0 * d_dot_n * nx
    rfy = dy - 2.0 * d_dot_n * ny
    rfz = dz - 2.0 * d_dot_n * nz
    rfx, rfy, rfz = _unit3(rfx, rfy, rfz)
    mx = rfx + fw * rux
    my = rfy + fw * ruy
    mz = rfz + fw * ruz
    metal_ok = (mx * nx + my * ny + mz * nz) > 0.0

    # ---- Dielectric ----
    ri = torch.where(front, 1.0 / iw, iw)
    ux, uy, uz = _unit3(dx, dy, dz)
    cos_t = _min1(-(ux * nx + uy * ny + uz * nz))
    sin2 = 1.0 - cos_t * cos_t
    s2pos = sin2 > 0.0
    sin_t = torch.where(s2pos, torch.sqrt(torch.where(s2pos, sin2, 1.0)), 0.0)
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    refl = r0 + (1.0 - r0) * _pow5(1.0 - cos_t)
    choose_refl = cannot | (refl > u)
    u_dot_n = ux * nx + uy * ny + uz * nz
    gx = ux - 2.0 * u_dot_n * nx
    gy = uy - 2.0 * u_dot_n * ny
    gz = uz - 2.0 * u_dot_n * nz
    cos_r = _min1(-(ux * nx + uy * ny + uz * nz))
    perp_x = ri * (ux + cos_r * nx)
    perp_y = ri * (uy + cos_r * ny)
    perp_z = ri * (uz + cos_r * nz)
    k = _abs(1.0 - (perp_x * perp_x + perp_y * perp_y + perp_z * perp_z))
    kpos = k > 0.0
    para = -torch.where(kpos, torch.sqrt(torch.where(kpos, k, 1.0)), 0.0)
    fx2 = perp_x + para * nx
    fy2 = perp_y + para * ny
    fz2 = perp_z + para * nz
    dlx = torch.where(choose_refl, gx, fx2)
    dly = torch.where(choose_refl, gy, fy2)
    dlz = torch.where(choose_refl, gz, fz2)

    # ---- select by material ----
    is_lam = mt == LAMBERTIAN
    is_met = mt == METAL
    is_die = mt == DIELECTRIC
    is_tra = mt == TRANSPARENT
    is_abs = mt == ABSORB

    def pick(lam, met, die, other):
        return torch.where(is_lam, lam, torch.where(is_met, met, torch.where(is_die, die, other)))

    ndx, ndy, ndz = pick(lx, mx, dlx, dx), pick(ly, my, dly, dy), pick(lz, mz, dlz, dz)
    white = is_die | is_tra
    scr = torch.where(white, 1.0, awr)
    scg = torch.where(white, 1.0, awg)
    scb = torch.where(white, 1.0, awb)
    scattered = (~is_abs) & (metal_ok | ~is_met)
    nox = torch.where(is_tra, ox, px)
    noy = torch.where(is_tra, oy, py)
    noz = torch.where(is_tra, oz, pz)

    # ---- the merge: sky on a miss, pass-through unless scattered ----
    finish_miss = act & ~hit
    keep = act & hit & scattered
    sa = 0.5 * (uy + 1.0)
    skyr = (1.0 - sa) * SKY_WHITE[0] + sa * SKY_BLUE[0]
    skyg = (1.0 - sa) * SKY_WHITE[1] + sa * SKY_BLUE[1]
    skyb = (1.0 - sa) * SKY_WHITE[2] + sa * SKY_BLUE[2]
    c2r = torch.where(finish_miss, ar * skyr, 0.0)
    c2g = torch.where(finish_miss, ag * skyg, 0.0)
    c2b = torch.where(finish_miss, ab * skyb, 0.0)
    return (
        torch.where(keep, nox, ox), torch.where(keep, noy, oy), torch.where(keep, noz, oz),
        torch.where(keep, ndx, dx), torch.where(keep, ndy, dy), torch.where(keep, ndz, dz),
        torch.where(keep, ar * scr, ar), torch.where(keep, ag * scg, ag),
        torch.where(keep, ab * scb, ab),
        c2r, c2g, c2b,
    )
