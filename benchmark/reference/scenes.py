"""The scenes the benchmark renders, made on the host with NumPy: the
inputs that the program and the reference are both handed.

A scene is a dict of arrays, one row per sphere: centers [N, 3], radii
[N], albedo [N, 3], fuzz [N], ior [N] (float32) and mat [N] (int32, the
codes below, which are the scene format both sides read).
"""

from __future__ import annotations

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2


class _Spheres:
    def __init__(self):
        self.rows = []

    def add(self, center, radius, albedo, mat, fuzz=0.0, ior=1.0):
        self.rows.append((tuple(float(c) for c in center), max(float(radius), 0.0),
                          tuple(float(a) for a in albedo), int(mat), min(float(fuzz), 1.0),
                          float(ior)))

    def lambertian(self, center, radius, albedo):
        self.add(center, radius, albedo, LAMBERTIAN)

    def metal(self, center, radius, albedo, fuzz):
        self.add(center, radius, albedo, METAL, fuzz=fuzz)

    def dielectric(self, center, radius, ior):
        self.add(center, radius, (1.0, 1.0, 1.0), DIELECTRIC, ior=ior)

    def arrays(self) -> dict:
        c, r, a, m, f, i = zip(*self.rows)
        f32 = lambda x: np.asarray(x, np.float32)
        return dict(centers=f32(c), radii=f32(r), albedo=f32(a), mat=np.asarray(m, np.int32),
                    fuzz=f32(f), ior=f32(i))


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) & (2**64 - 1))


def rtiow_final(seed: int, grid: int = 11) -> dict:
    """Ray Tracing in One Weekend's final scene: the ground sphere, one
    small sphere (radius 0.2) per cell of the (2 grid)^2 grid, jittered,
    80% Lambertian, 15% metal, 5% glass, none within 0.9 of (4, 0.2, 0),
    and the three feature spheres (glass, Lambertian, metal)."""
    rng = _rng(seed)
    s = _Spheres()
    s.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for a in range(-grid, grid):
        for b in range(-grid, grid):
            choose = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.sqrt(np.sum((np.array(center) - np.array([4.0, 0.2, 0.0])) ** 2)) <= 0.9:
                continue
            if choose < 0.8:
                s.lambertian(center, 0.2, rng.random(3) * rng.random(3))
            elif choose < 0.95:
                s.metal(center, 0.2, rng.uniform(0.5, 1.0, 3), rng.uniform(0.0, 0.5))
            else:
                s.dielectric(center, 0.2, 1.5)
    s.dielectric((0.0, 1.0, 0.0), 1.0, 1.5)
    s.lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
    s.metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)
    return s.arrays()


GENERATORS = {"rtiow_final": rtiow_final}


def make_scene(spec: dict, seed: int) -> dict:
    """The scene of a configuration's "scene" entry for a run's seed: the
    configuration's own spheres (its "seed" fixes them, as a deployment
    renders its scene), in an order drawn from the run's seed.  Every run
    so renders the same spheres, and the same work, whatever its seed."""
    kw = {k: v for k, v in spec.items() if k not in ("generator", "seed")}
    scene = GENERATORS[spec["generator"]](spec["seed"], **kw)
    order = _rng(seed).permutation(len(scene["radii"]))
    return {k: v[order] for k, v in scene.items()}
