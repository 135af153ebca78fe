"""Scene as a structure of arrays: one tensor per sphere field.

The port's counterpart of distributed_raytracer_tpu/models/scene.py.  A
scene is built on the host (CPU tensors); the render entry points move it
to their device with `Scene.to`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

# Material type codes (the reference's five Material impls).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
ABSORB = 3       # always absorbs
TRANSPARENT = 4  # passes the ray through, white attenuation

_FIELDS = ("centers", "radii", "albedo", "mat_type", "fuzz", "ior")
_DIFF_FIELDS = ("centers", "radii", "albedo", "fuzz", "ior")


@dataclasses.dataclass(frozen=True)
class Scene:
    """All spheres in the scene, SoA.  Float fields are the differentiable
    parameters; mat_type is an integer control field."""

    centers: torch.Tensor   # [N, 3] f32
    radii: torch.Tensor     # [N]    f32 (clamped >= 0 at build time)
    albedo: torch.Tensor    # [N, 3] f32
    mat_type: torch.Tensor  # [N]    i32
    fuzz: torch.Tensor      # [N]    f32 (clamped <= 1 at build time)
    ior: torch.Tensor       # [N]    f32 (1.0 for non-dielectrics)

    @property
    def num_spheres(self) -> int:
        return self.centers.shape[0]

    def to(self, device: Union[str, torch.device]) -> "Scene":
        return Scene(**{k: getattr(self, k).to(device) for k in _FIELDS})

    def diff_params(self) -> Dict[str, torch.Tensor]:
        """The differentiable fields, as a dict."""
        return {k: getattr(self, k) for k in _DIFF_FIELDS}

    def with_diff_params(self, params: Dict[str, torch.Tensor]) -> "Scene":
        return dataclasses.replace(self, **params)

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray],
                   device: Union[str, torch.device]) -> "Scene":
        """A scene from its six arrays as numpy (e.g. `{k: np.asarray(v)}`
        of the JAX package's Scene fields), with the port's dtypes."""
        out = {}
        for k in _FIELDS:
            dtype = torch.int32 if k == "mat_type" else torch.float32
            out[k] = torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
        return cls(**out)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k).detach().cpu().numpy() for k in _FIELDS}


class SceneBuilder:
    """Imperative scene construction: material constructors accumulate
    into host lists that `build` freezes into a Scene."""

    def __init__(self) -> None:
        self._centers: List[Tuple[float, float, float]] = []
        self._radii: List[float] = []
        self._albedo: List[Tuple[float, float, float]] = []
        self._mat_type: List[int] = []
        self._fuzz: List[float] = []
        self._ior: List[float] = []

    def _add(self, center, radius, albedo, mat_type, fuzz=0.0, ior=1.0) -> "SceneBuilder":
        self._centers.append(tuple(float(c) for c in center))
        self._radii.append(max(float(radius), 0.0))  # sphere.rs:14 clamp
        self._albedo.append(tuple(float(a) for a in albedo))
        self._mat_type.append(int(mat_type))
        self._fuzz.append(min(float(fuzz), 1.0))  # material.rs:66 clamp
        self._ior.append(float(ior))
        return self

    def add_lambertian(self, center, radius, albedo) -> "SceneBuilder":
        return self._add(center, radius, albedo, LAMBERTIAN)

    def add_metal(self, center, radius, albedo, fuzz) -> "SceneBuilder":
        return self._add(center, radius, albedo, METAL, fuzz=fuzz)

    def add_dielectric(self, center, radius, refraction_index) -> "SceneBuilder":
        return self._add(center, radius, (1.0, 1.0, 1.0), DIELECTRIC, ior=refraction_index)

    def add_absorbing(self, center, radius) -> "SceneBuilder":
        return self._add(center, radius, (0.0, 0.0, 0.0), ABSORB)

    def add_transparent(self, center, radius) -> "SceneBuilder":
        return self._add(center, radius, (1.0, 1.0, 1.0), TRANSPARENT)

    def build(self, pad_to: Optional[int] = None) -> Scene:
        """Freeze into a CPU Scene.  pad_to pads the sphere axis with
        spheres of radius 0 and the ABSORB material at the origin; the
        intersection code gives radius <= 0 an r^2 of -1, so they never
        hit."""
        n = len(self._centers)
        if n == 0:
            raise ValueError("empty scene")
        m = pad_to if pad_to is not None else n
        if m < n:
            raise ValueError(f"pad_to={m} < num spheres {n}")
        pad = m - n

        def f32(lst, fill):
            return np.asarray(list(lst) + [fill] * pad, dtype=np.float32)

        return Scene.from_numpy(
            dict(
                centers=f32(self._centers, (0.0, 0.0, 0.0)),
                radii=f32(self._radii, 0.0),
                albedo=f32(self._albedo, (0.0, 0.0, 0.0)),
                mat_type=np.asarray(self._mat_type + [ABSORB] * pad, np.int32),
                fuzz=f32(self._fuzz, 0.0),
                ior=f32(self._ior, 1.0),
            ),
            device="cpu",
        )
