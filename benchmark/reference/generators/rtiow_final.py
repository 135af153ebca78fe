"""Ray Tracing in One Weekend's final scene (the book's "Where Next?: A Final
Render")."""

from __future__ import annotations

import numpy as np

from benchmark.reference.scenes import SceneRows, seeded_rng


def make(seed: int, grid: int = 11) -> dict:
    """The ground sphere, one small sphere (radius 0.2) per cell of the
    (2 grid)^2 grid, jittered, 80% Lambertian, 15% metal, 5% glass, none
    within 0.9 of (4, 0.2, 0), and the three feature spheres (glass,
    Lambertian, metal)."""
    rng = seeded_rng(seed)
    s = SceneRows()
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
