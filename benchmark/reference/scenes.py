"""The scenes the benchmark renders, made on the host with NumPy: the
inputs that the program and the reference are both handed.

A scene is a dict of arrays, one row per sphere: centers [N, 3], radii
[N], albedo [N, 3], fuzz [N], ior [N] (float32) and mat [N] (int32, the
codes below, which are the scene format both sides read).

A configuration's "scene" entry names its generator, the file
generators/<generator>.py, which exports make(seed, **kw) -> dict of those
six arrays (built with SceneRows); the entry's other keys are its
keyword arguments.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
GENERATOR_DIR = Path(__file__).resolve().parent / "generators"


class SceneRows:
    """A scene built sphere by sphere; arrays() gives its six arrays."""

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


def seeded_rng(seed: int) -> np.random.Generator:
    """NumPy's generator for any whole-number seed, negative or past 64 bits."""
    return np.random.default_rng(int(seed) & (2**64 - 1))


def generator(name: str) -> Callable[..., dict]:
    """The make function of generators/<name>.py."""
    path = GENERATOR_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no scene generator {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"bench_scene_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def make_scene(spec: dict, seed: int) -> dict:
    """The scene of a configuration's "scene" entry for a run's seed: the
    configuration's own spheres (its "seed" fixes them, as a deployment
    renders its scene), in an order drawn from the run's seed.  Every run
    so renders the same spheres, and the same work, whatever its seed."""
    kw = {k: v for k, v in spec.items() if k not in ("generator", "seed")}
    scene = generator(spec["generator"])(spec["seed"], **kw)
    order = seeded_rng(seed).permutation(len(scene["radii"]))
    return {k: v[order] for k, v in scene.items()}
