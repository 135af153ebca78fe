"""Scene files: user-authored scenes in and out.  The port of
distributed_raytracer_tpu/models/scene_io.py, in the same formats, so a
file written by either package loads in the other to the same arrays.

A scene (and optionally a camera) round-trips through JSON or NPZ and
feeds every engine through `render --scene file`.  Two formats, chosen by
extension:

- ``.json``, human-authorable.  Each sphere is a typed object::

      {"format": "dray-scene-v1",
       "camera": {...CameraConfig fields...},          # optional
       "spheres": [
         {"type": "lambertian", "center": [0,-100.5,-1], "radius": 100,
          "albedo": [0.8, 0.8, 0.0]},
         {"type": "metal", ..., "fuzz": 0.3},
         {"type": "dielectric", ..., "refraction_index": 1.5},
         {"type": "absorb", ...}, {"type": "transparent", ...}]}

- ``.npz``, the SoA arrays verbatim (centers, radii, albedo, mat_type,
  fuzz, ior) for scenes too large for JSON; the optional camera rides
  along as a JSON string entry.

Padding spheres (radius <= 0 with the ABSORB material) are dropped when a
JSON file is written, and `pad_to` pads again on load.  The build-time
clamps (radius >= 0, fuzz <= 1) are applied on load, so a hand-written
file cannot make a scene the builder forbids.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

from distributed_raytracer_tpu_torch.models.scene import (
    ABSORB,
    DIELECTRIC,
    LAMBERTIAN,
    METAL,
    TRANSPARENT,
    Scene,
    SceneBuilder,
)
from distributed_raytracer_tpu_torch.ops.camera import Camera

FORMAT = "dray-scene-v1"

_MAT_NAMES = {
    LAMBERTIAN: "lambertian",
    METAL: "metal",
    DIELECTRIC: "dielectric",
    ABSORB: "absorb",
    TRANSPARENT: "transparent",
}
_MAT_CODES = {v: k for k, v in _MAT_NAMES.items()}


# ---- camera <-> dict ----

def _floats(x) -> list:
    return [float(v) for v in np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)]


def camera_to_dict(camera: Camera) -> dict:
    """A CameraConfig-shaped dict: the camera's whole configuration."""
    return {
        "aspect_ratio": camera.image_width / camera.image_height,
        "image_width": camera.image_width,
        "samples_per_pixel": camera.samples_per_pixel,
        "max_depth": camera.max_depth,
        "vfov": float(camera.vfov),
        "lookfrom": _floats(camera.lookfrom),
        "lookat": _floats(camera.lookat),
        "vup": _floats(camera.vup),
        "defocus_angle": float(camera.defocus_angle),
        "focus_dist": float(camera.focus_dist),
    }


def camera_from_dict(d: dict) -> Camera:
    """The camera of a CameraConfig-shaped dict; unknown fields raise."""
    from distributed_raytracer_tpu_torch.utils.config import CameraConfig

    known = {f.name for f in dataclasses.fields(CameraConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown camera fields: {sorted(unknown)}")
    d = dict(d)
    for k in ("lookfrom", "lookat", "vup"):
        if k in d:
            d[k] = tuple(float(x) for x in d[k])
    return CameraConfig(**d).build()


# ---- JSON ----

def scene_to_dict(scene: Scene, camera: Optional[Camera] = None,
                  keep_padding: bool = False) -> dict:
    """The scene (and optional camera) as a plain dict.  Padding spheres
    are dropped unless keep_padding."""
    a = scene.to_numpy()
    centers = a["centers"].astype(np.float64)
    radii = a["radii"].astype(np.float64)
    albedo = a["albedo"].astype(np.float64)
    mat = a["mat_type"]
    fuzz = a["fuzz"].astype(np.float64)
    ior = a["ior"].astype(np.float64)

    spheres = []
    for i in range(centers.shape[0]):
        code = int(mat[i])
        if not keep_padding and radii[i] <= 0.0 and code == ABSORB:
            continue
        if code not in _MAT_NAMES:
            raise ValueError(f"sphere {i}: unknown material code {code}")
        s = {
            "type": _MAT_NAMES[code],
            "center": [float(x) for x in centers[i]],
            "radius": float(radii[i]),
        }
        if code in (LAMBERTIAN, METAL):
            s["albedo"] = [float(x) for x in albedo[i]]
        if code == METAL:
            s["fuzz"] = float(fuzz[i])
        if code == DIELECTRIC:
            s["refraction_index"] = float(ior[i])
        spheres.append(s)

    d = {"format": FORMAT, "spheres": spheres}
    if camera is not None:
        d["camera"] = camera_to_dict(camera)
    return d


def scene_to_json(scene: Scene, camera: Optional[Camera] = None,
                  keep_padding: bool = False) -> str:
    return json.dumps(scene_to_dict(scene, camera, keep_padding), indent=2)


def builder_from_dicts(spheres: list) -> SceneBuilder:
    """A SceneBuilder from a list of typed sphere dicts."""
    b = SceneBuilder()
    for i, s in enumerate(spheres):
        try:
            kind = s["type"]
            center = tuple(float(x) for x in s["center"])
            if len(center) != 3:
                raise ValueError(f"center must have 3 components, got {len(center)}")
            radius = float(s["radius"])
        except KeyError as e:
            raise ValueError(f"sphere {i}: missing required field {e}") from None
        if kind == "lambertian":
            b.add_lambertian(center, radius, _color(s, i))
        elif kind == "metal":
            b.add_metal(center, radius, _color(s, i), float(s.get("fuzz", 0.0)))
        elif kind == "dielectric":
            b.add_dielectric(center, radius, float(s.get("refraction_index", 1.5)))
        elif kind == "absorb":
            b.add_absorbing(center, radius)
        elif kind == "transparent":
            b.add_transparent(center, radius)
        else:
            raise ValueError(f"sphere {i}: unknown type {kind!r}; have {sorted(_MAT_CODES)}")
    return b


def _color(s: dict, i: int) -> Tuple[float, float, float]:
    t = tuple(float(x) for x in s.get("albedo", (1.0, 1.0, 1.0)))
    if len(t) != 3:
        raise ValueError(f"sphere {i}: albedo must have 3 components")
    return t


def scene_from_dict(d: dict, pad_to: Optional[int] = None
                    ) -> Tuple[Scene, Optional[Camera]]:
    if d.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} file (format={d.get('format')!r})")
    spheres = d.get("spheres", [])
    if not spheres:
        raise ValueError("scene has no spheres")
    scene = builder_from_dicts(spheres).build(pad_to=pad_to)
    cam = camera_from_dict(d["camera"]) if "camera" in d else None
    return scene, cam


def scene_from_json(text: str, pad_to: Optional[int] = None
                    ) -> Tuple[Scene, Optional[Camera]]:
    return scene_from_dict(json.loads(text), pad_to=pad_to)


# ---- NPZ (bulk scenes) ----

def _scene_to_npz_dict(scene: Scene, camera: Optional[Camera]) -> dict:
    a = scene.to_numpy()
    d = {
        "format": np.asarray(FORMAT),
        "centers": a["centers"].astype(np.float32),
        "radii": a["radii"].astype(np.float32),
        "albedo": a["albedo"].astype(np.float32),
        "mat_type": a["mat_type"].astype(np.int32),
        "fuzz": a["fuzz"].astype(np.float32),
        "ior": a["ior"].astype(np.float32),
    }
    if camera is not None:
        d["camera_json"] = np.asarray(json.dumps(camera_to_dict(camera)))
    return d


def _scene_from_npz(f, pad_to: Optional[int]) -> Tuple[Scene, Optional[Camera]]:
    if str(f["format"]) != FORMAT:
        raise ValueError(f"not a {FORMAT} npz (format={f['format']!r})")
    n = int(f["radii"].shape[0])
    m = pad_to if pad_to is not None else n
    if m < n:
        raise ValueError(f"pad_to={m} < num spheres {n}")
    pad = m - n

    def p2(x):  # [N, 3]
        return np.pad(np.asarray(x, np.float32), ((0, pad), (0, 0)))

    def p1(x, fill, dt=np.float32):
        return np.pad(np.asarray(x, dt), (0, pad), constant_values=fill)

    scene = Scene.from_numpy(dict(
        centers=p2(f["centers"]),
        radii=np.maximum(p1(f["radii"], 0.0), np.float32(0.0)),
        albedo=p2(f["albedo"]),
        mat_type=p1(f["mat_type"], ABSORB, np.int32),
        fuzz=np.minimum(p1(f["fuzz"], 0.0), np.float32(1.0)),
        ior=p1(f["ior"], 1.0),
    ), device="cpu")
    cam = None
    if "camera_json" in getattr(f, "files", f):
        cam = camera_from_dict(json.loads(str(f["camera_json"])))
    return scene, cam


# ---- file dispatch ----

def save_scene(path: str, scene: Scene, camera: Optional[Camera] = None) -> None:
    """Write a scene file; the format is chosen by extension (.json, .npz)."""
    if path.endswith(".npz"):
        np.savez(path, **_scene_to_npz_dict(scene, camera))
    elif path.endswith(".json"):
        with open(path, "w") as fh:
            fh.write(scene_to_json(scene, camera))
    else:
        raise ValueError(f"unknown scene extension (want .json or .npz): {path}")


def load_scene(path: str, pad_to: Optional[int] = None
               ) -> Tuple[Scene, Optional[Camera]]:
    """Read a scene file (.json or .npz): (CPU scene, camera or None)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return _scene_from_npz(f, pad_to)
    if path.endswith(".json"):
        with open(path) as fh:
            return scene_from_json(fh.read(), pad_to=pad_to)
    raise ValueError(f"unknown scene extension (want .json or .npz): {path}")
