"""Render job configuration: the port of distributed_raytracer_tpu/utils/
config.py.

A render is described by a RenderJobConfig built from a preset, a scene
file or kwargs, and serialized as JSON beside its checkpoint so a job can
be rerun.  CameraConfig is the camera's whole configuration surface
(make_camera's arguments).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

from distributed_raytracer_tpu_torch.models import presets
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import Camera, make_camera


@dataclasses.dataclass
class CameraConfig:
    aspect_ratio: float = 1.0
    image_width: int = 100
    samples_per_pixel: int = 10
    max_depth: int = 10
    vfov: float = 90.0
    lookfrom: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0

    def build(self) -> Camera:
        return make_camera(**dataclasses.asdict(self))


@dataclasses.dataclass
class RenderJobConfig:
    preset: Optional[str] = None      # config1..config5, or None for a scene file
    scene_path: Optional[str] = None  # scene file (models/scene_io.py); wins over the
                                      # preset for the scene, and for the camera
                                      # when the file carries one
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    seed: int = 0
    scene_seed: int = 0
    spp: Optional[int] = None         # overrides camera.samples_per_pixel
    batch: int = 16                   # samples per batch
    tile_size: int = 32768
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 1
    output: Optional[str] = None      # .ppm path
    n_scene_shards: int = 1           # sphere-axis sharding
    engine: str = "auto"              # auto | scan | wavefront | fused | mega
    fill: str = "row"                 # row | shuffled

    def build(self) -> Tuple[Scene, Camera]:
        """(scene, camera): the scene file's (its camera, else the preset's,
        else this config's camera), or the preset's."""
        if self.scene_path:
            from distributed_raytracer_tpu_torch.models.scene_io import load_scene

            scene, cam = load_scene(self.scene_path)
            if cam is None:
                cam = (presets.get_config(self.preset)[1] if self.preset
                       else self.camera.build())
        elif self.preset:
            scene, cam = presets.get_config(self.preset)
        else:
            raise ValueError(
                "custom scenes: set scene_path (a scene_io file), a preset, "
                "or use the SceneBuilder API")
        if self.spp is not None:
            cam = cam.replace(samples_per_pixel=self.spp)
        return scene, cam

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RenderJobConfig":
        d = json.loads(s)
        cam = d.pop("camera", None)
        cfg = cls(**d)
        if cam:
            cfg.camera = CameraConfig(**cam)
        return cfg
