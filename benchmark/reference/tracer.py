"""A plain path tracer of the book's spheres, the reference that decides
whether the program's images and scene gradients are correct.

Every ray is traced to its end against every sphere: a dense closest hit
(the quadratic in the oc form, near root then far root above T_MIN, the
first least t wins), then the shading of the book's materials with five
hashed draws per (ray, bounce): a random unit vector by Box-Muller for the
Lambertian scatter and the metal's fuzz, Schlick's reflectance against a
uniform for glass, and the sky gradient for a miss.  No culling, no pool,
no kernel.  Arithmetic is float32 in the renderer's expression order, so
that where no transcendental rounds otherwise the reference's paths are
the program's to the bit; `dtype` runs the same trace in a lower
precision (the control).

Gradients: `trace` with grad=True keeps autograd on from the five scene
fields (centers, radii, albedo, fuzz, ior) to the colors.  The closest
hit is found without autograd over all spheres; the winner's t is then
worked out again from its own centre and radius with autograd on, the same
arithmetic, so the value is the same and the gradient reaches the winner.
A silhouette or a reflect/refract choice is a step, not differentiated.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference.draws import DEPTH_STRIDE, M32, hash_u01, wrap_i32

T_MIN = 1e-3
BIG = 1e30
NEAR_ZERO = 1e-6
SKY_TOP = (0.5, 0.7, 1.0)
LAMBERTIAN, METAL, DIELECTRIC, ABSORB, TRANSPARENT = 0, 1, 2, 3, 4
_SWEEP_ELEMS = 1 << 24  # rays x spheres per no-grad sweep chunk


class Spheres:
    """The scene as tensors on one device, the float fields optionally
    leaves of autograd."""

    def __init__(self, scene: Dict, device, dtype=torch.float32, grad: bool = False):
        def t(k):
            x = torch.as_tensor(scene[k], dtype=torch.float32).to(device=device, dtype=dtype)
            return x.requires_grad_() if grad else x

        self.centers, self.radii, self.albedo = t("centers"), t("radii"), t("albedo")
        self.fuzz, self.ior = t("fuzz"), t("ior")
        self.mat = torch.as_tensor(scene["mat"]).to(device=device, dtype=torch.int64)
        r = self.radii.detach()
        self.r2 = torch.where(r > 0.0, r * r, -1.0)  # a sphere of radius 0 never hits
        self.live = int((r > 0.0).sum())

    def leaves(self):
        return {"centers": self.centers, "radii": self.radii, "albedo": self.albedo,
                "fuzz": self.fuzz, "ior": self.ior}


def _roots(ocx, ocy, ocz, r2, dx, dy, dz, a, inv_a):
    h = dx * ocx + dy * ocy + dz * ocz
    c_q = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = h * h - a * c_q
    ok = disc >= 0.0
    pos = disc > 0.0  # sqrt(0) is 0; the double where keeps its gradient finite
    sqrtd = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    rn = (h - sqrtd) * inv_a
    rf = (h + sqrtd) * inv_a
    t = torch.where(ok & (rn > T_MIN), rn, torch.where(ok & (rf > T_MIN), rf, BIG))
    return t, ok


@torch.no_grad()
def closest(s: Spheres, o, d, a, inv_a, counts: Optional[dict]):
    """(winner index [R] int64, hit [R] bool) over every sphere; counts,
    if given, gains the tests whose discriminant is not negative."""
    c = s.centers.detach()
    cx, cy, cz, r2 = c[:, 0][None], c[:, 1][None], c[:, 2][None], s.r2[None]
    live = (s.r2 >= 0.0)[None]
    step = max(1, _SWEEP_ELEMS // c.shape[0])
    idx, hit = [], []
    for k in range(0, o.shape[0], step):
        sl = slice(k, k + step)
        ox, oy, oz = (o[sl, j].detach()[:, None] for j in range(3))
        dx, dy, dz = (d[sl, j].detach()[:, None] for j in range(3))
        t, ok = _roots(cx - ox, cy - oy, cz - oz, r2, dx, dy, dz, a[sl].detach()[:, None],
                       inv_a[sl].detach()[:, None])
        t_best, i = torch.min(t, dim=1)
        idx.append(i)
        hit.append(t_best < BIG * 0.5)
        if counts is not None:
            counts["near"] += int((ok & live).sum())
    return torch.cat(idx), torch.cat(hit)


def bounce(s: Spheres, o, d, rid, seed, counts: Optional[dict]):
    """One bounce of rays o, d [R, 3] with ray ids rid: returns (next o,
    next d, attenuation factor [R, 3], color [R, 3] of the rays that
    finish here, finished [R] bool)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    idx, hit = closest(s, o, d, a, inv_a, counts)
    c = s.centers[idx]
    rr = s.radii[idx]
    r2 = torch.where(rr > 0.0, rr * rr, -1.0)
    t, _ = _roots(c[:, 0] - ox, c[:, 1] - oy, c[:, 2] - oz, r2, dx, dy, dz, a, inv_a)
    zero = torch.zeros_like(ox)
    # the winner's attributes, zero on a miss
    wcx, wcy, wcz, wrr = (torch.where(hit, x, zero) for x in (c[:, 0], c[:, 1], c[:, 2], rr))
    alb = s.albedo[idx]
    war, wag, wab = (torch.where(hit, alb[:, k], zero) for k in range(3))
    wfz = torch.where(hit, s.fuzz[idx], zero)
    wio = torch.where(hit, s.ior[idx], zero)
    mt = torch.where(hit, s.mat[idx], LAMBERTIAN)

    th = torch.where(hit, t, 1.0)
    px, py, pz = ox + th * dx, oy + th * dy, oz + th * dz
    saferr = torch.where(wrr > 0.0, wrr, 1.0)
    nx, ny, nz = (px - wcx) / saferr, (py - wcy) / saferr, (pz - wcz) / saferr
    d_dot_n = dx * nx + dy * ny + dz * nz
    front = d_dot_n < 0.0
    fs = torch.where(front, 1.0, -1.0).to(dx.dtype)
    nx, ny, nz = nx * fs, ny * fs, nz * fs

    u1, u2, u3, u4, u_choice = (hash_u01(rid, seed, k).to(dx.dtype) for k in range(5))
    rad1 = torch.sqrt(-2.0 * torch.log(u1))
    g1 = rad1 * torch.cos(6.2831853 * u2)
    g2 = rad1 * torch.sin(6.2831853 * u2)
    g3 = torch.sqrt(-2.0 * torch.log(u3)) * torch.cos(6.2831853 * u4)
    gn = torch.rsqrt(g1 * g1 + g2 * g2 + g3 * g3 + 1e-20)
    rux, ruy, ruz = g1 * gn, g2 * gn, g3 * gn

    # Lambertian: normal plus a random unit vector, the normal if that is ~0
    lx, ly, lz = nx + rux, ny + ruy, nz + ruz
    near0 = (lx.abs() < NEAR_ZERO) & (ly.abs() < NEAR_ZERO) & (lz.abs() < NEAR_ZERO)
    lx, ly, lz = torch.where(near0, nx, lx), torch.where(near0, ny, ly), torch.where(near0, nz, lz)

    # metal: mirror about the oriented normal, normalized, plus fuzz
    rx = dx - 2.0 * d_dot_n * fs * nx
    ry = dy - 2.0 * d_dot_n * fs * ny
    rz = dz - 2.0 * d_dot_n * fs * nz
    rinv = torch.rsqrt(rx * rx + ry * ry + rz * rz + 1e-20)
    mx, my, mz = rx * rinv + wfz * rux, ry * rinv + wfz * ruy, rz * rinv + wfz * ruz
    metal_ok = (mx * nx + my * ny + mz * nz) > 0.0

    # glass: Schlick's reflectance against u_choice, total internal reflection
    ior = torch.where(wio > 0.0, wio, 1.0)
    ri = torch.where(front, 1.0 / ior, ior)
    dinv = torch.rsqrt(a)
    ux, uy, uz = dx * dinv, dy * dinv, dz * dinv
    cos_t = torch.clamp_max(-(ux * nx + uy * ny + uz * nz), 1.0)
    sin2 = torch.clamp_min(1.0 - cos_t * cos_t, 0.0)
    cannot = ri * ri * sin2 > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    schlick = r0 + (1.0 - r0) * omc * omc * omc * omc * omc
    reflect = cannot | (schlick > u_choice)
    qx, qy, qz = ri * (ux + cos_t * nx), ri * (uy + cos_t * ny), ri * (uz + cos_t * nz)
    k = torch.abs(1.0 - (qx * qx + qy * qy + qz * qz))
    para = -torch.where(k > 0.0, torch.sqrt(torch.where(k > 0.0, k, 1.0)), 0.0)
    u_dot_n = ux * nx + uy * ny + uz * nz
    gx, gy, gz = ux - 2.0 * u_dot_n * nx, uy - 2.0 * u_dot_n * ny, uz - 2.0 * u_dot_n * nz
    gdx = torch.where(reflect, gx, qx + para * nx)
    gdy = torch.where(reflect, gy, qy + para * ny)
    gdz = torch.where(reflect, gz, qz + para * nz)

    is_lam, is_met, is_die = mt == LAMBERTIAN, mt == METAL, mt == DIELECTRIC
    is_tra, is_abs = mt == TRANSPARENT, mt == ABSORB

    def pick(lam, met, die, other):
        return torch.where(is_lam, lam, torch.where(is_met, met, torch.where(is_die, die, other)))

    ndx, ndy, ndz = pick(lx, mx, gdx, dx), pick(ly, my, gdy, dy), pick(lz, mz, gdz, dz)
    white = is_die | is_tra
    att = [torch.where(white, 1.0, x) for x in (war, wag, wab)]
    scattered = (~is_abs) & (metal_ok | ~is_met)
    keep = hit & scattered
    sky_a = 0.5 * (dy * dinv + 1.0)
    color = torch.stack([torch.where(hit, 0.0, (1.0 - sky_a) + sky_a * top) for top in SKY_TOP], -1)
    nox, noy, noz = (torch.where(is_tra, a_, p_) for a_, p_ in ((ox, px), (oy, py), (oz, pz)))
    nxt_o = torch.stack([torch.where(keep, x, y) for x, y in ((nox, ox), (noy, oy), (noz, oz))], -1)
    nxt_d = torch.stack([torch.where(keep, x, y) for x, y in ((ndx, dx), (ndy, dy), (ndz, dz))], -1)
    factor = torch.stack([torch.where(keep, x, 1.0) for x in att], -1)
    return nxt_o, nxt_d, factor, color, ~keep


def trace(s: Spheres, o, d, rid, bounce_seed, max_depth: int,
          counts: Optional[dict] = None) -> torch.Tensor:
    """Colors [R, 3] of rays o, d with ray ids rid (int64), each traced to
    its end or to max_depth bounces (black); bounce_seed is an int or an
    int64 [R] of each ray's seed.  counts, if given, gains
    "bounces" (ray-bounce closest hits run) and "near" (their tests with a
    discriminant not negative against live spheres)."""
    r = o.shape[0]
    alive = torch.arange(r, device=o.device)
    atten = torch.ones_like(o)
    done_ids, done_cols = [], []
    for depth in range(max_depth):
        if alive.numel() == 0:
            break
        if counts is not None:
            counts["bounces"] += alive.numel()
        if torch.is_tensor(bounce_seed):
            seed = (bounce_seed[alive] + depth * DEPTH_STRIDE) & M32
        else:
            seed = wrap_i32(bounce_seed + depth * DEPTH_STRIDE)
        o, d, factor, color, fin = bounce(s, o, d, rid[alive], seed, counts)
        done_ids.append(alive[fin])
        done_cols.append(atten[fin] * color[fin])
        atten = atten * factor
        live = ~fin
        alive, o, d, atten = alive[live], o[live], d[live], atten[live]
    out = torch.zeros(r, 3, dtype=o.dtype, device=o.device)
    if done_ids:
        out = out.index_put((torch.cat(done_ids),), torch.cat(done_cols))
    return out
