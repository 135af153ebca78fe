"""Eric Haines' Standard Procedural Databases scene `balls`, the
sphereflake (E. Haines, "A Proposal for Standard Graphics Environments",
IEEE CG&A 7(11), 1987; the SPD's balls.c).

A sphere of radius r whose direction is u has nine children of radius
r/3, each centred at its parent's centre plus (4r/3) v_i, where v_i is
the i-th direction of `objset` turned by the least rotation that takes
+z to u; v_i is then the child's direction.  In the frame of u = +z,
`objset` holds six directions at elevation 0 (azimuths 15 + 60k degrees)
and three at elevation asin(sqrt(2/3)) (azimuths 45 + 120k degrees), in
balls.c's order.  The root has centre (0, 0, 0), radius 0.5 and direction
+z; size factor n gives levels 0..n, 1 + 9 + ... + 9^n spheres, written
depth first as balls.c writes them.

The flake's surface (NFF fill colour (1, 0.9, 0.7), Kd 0.5, Ks 0.5) is a
mirror: each sphere is metal of albedo Ks x colour and fuzz 0.  The
ground square, the point lights and the constant background are not
modelled (the configuration's "reduced").  The flake is fixed: the seed
draws nothing.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.scenes import SceneRows

RADIUS = 0.5
CHILD_RATIO = 1.0 / 3.0
ALBEDO = (0.5, 0.45, 0.35)  # Ks 0.5 x the NFF fill colour (1.0, 0.9, 0.7)


def _axis_rotation(axis, angle: float) -> np.ndarray:
    """The right-handed rotation by angle about the unit axis (Rodrigues)."""
    k = np.asarray(axis, np.float64)
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(angle) * kx + (1.0 - np.cos(angle)) * (kx @ kx)


def objset() -> np.ndarray:
    """[9, 3] the children's directions about +z, as balls.c builds them:
    the trio (d, d, 0), (d, 0, -d), (0, d, -d), d = 1/sqrt(2), turned
    about (1, -1, 0)/sqrt(2) by asin(2/sqrt(6)), then copied at 0, 120 and
    240 degrees about z."""
    d = 1.0 / np.sqrt(2.0)
    trio = np.array([[d, d, 0.0], [d, 0.0, -d], [0.0, d, -d]])
    tilt = _axis_rotation(np.array([1.0, -1.0, 0.0]) / np.sqrt(2.0), np.arcsin(2.0 / np.sqrt(6.0)))
    trio = trio @ tilt.T
    return np.concatenate([trio @ _axis_rotation((0.0, 0.0, 1.0), k * 2.0 * np.pi / 3.0).T
                           for k in range(3)])


def to_direction(u) -> np.ndarray:
    """The least rotation that takes +z to the unit vector u: the identity
    for +z, a half turn about y for -z, else the turn about z x u by
    acos(u_z)."""
    u = np.asarray(u, np.float64)
    if u[2] >= 1.0:
        return np.eye(3)
    if u[2] <= -1.0:
        return _axis_rotation((0.0, 1.0, 0.0), np.pi)
    axis = np.cross((0.0, 0.0, 1.0), u)
    return _axis_rotation(axis / np.linalg.norm(axis), np.arccos(u[2]))


def flake(size_factor: int = 4) -> dict:
    """The sphereflake in float64, depth first: centers [N, 3], radii
    [N], directions [N, 3], parent [N] (-1 for the root) and level [N]."""
    base = objset()
    centers, radii, dirs, parent, level = [], [], [], [], []

    def out(center, radius, direction, up, depth):
        me = len(radii)
        centers.append(center)
        radii.append(radius)
        dirs.append(direction)
        parent.append(up)
        level.append(size_factor - depth)
        if depth == 0:
            return
        turned = base @ to_direction(direction).T
        for v in turned:
            out(center + radius * (1.0 + CHILD_RATIO) * v, radius * CHILD_RATIO, v, me,
                depth - 1)

    out(np.zeros(3), RADIUS, np.array([0.0, 0.0, 1.0]), -1, int(size_factor))
    return dict(centers=np.array(centers), radii=np.array(radii), directions=np.array(dirs),
                parent=np.array(parent, np.int64), level=np.array(level, np.int64))


def make(seed: int, size_factor: int = 4) -> dict:
    """The flake at this size factor as the six scene arrays; every sphere
    is the flake's mirror.  The seed draws nothing."""
    del seed  # the deployment's spheres are fixed
    f = flake(size_factor)
    s = SceneRows()
    for c, r in zip(f["centers"], f["radii"]):
        s.metal(c, r, ALBEDO, 0.0)
    return s.arrays()
