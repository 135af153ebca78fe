"""Scene files and job configs of the port (models/scene_io.py,
utils/config.py) against the JAX package's: a file written by either
loads in the other to the same arrays bit for bit, JSON and NPZ, with and
without a camera; padding dropped and restored; the load-time clamps and
validation errors of tests/test_scene_io.py; export-scene then render
--scene on the CPU equal to the preset's render."""

import json

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.models import scene_io as jio
from distributed_raytracer_tpu_torch.models import presets as tp
from distributed_raytracer_tpu_torch.models import scene_io as tio
from distributed_raytracer_tpu_torch.models.scene import SceneBuilder
from distributed_raytracer_tpu_torch.ops.camera import make_camera
from distributed_raytracer_tpu_torch.utils.config import CameraConfig, RenderJobConfig

FIELDS = ("centers", "radii", "albedo", "mat_type", "fuzz", "ior")
CAM_FIELDS = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v", "u", "v", "w",
              "defocus_disk_u", "defocus_disk_v", "vfov", "lookfrom", "lookat", "vup",
              "defocus_angle", "focus_dist")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _custom_port_scene():
    """Every material, a fuzz and radius the builder clamps, two pads."""
    return (SceneBuilder()
            .add_lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0))
            .add_metal((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.3)
            .add_dielectric((-1.0, 0.0, -1.0), 0.5, 1.5)
            .add_absorbing((0.25, 0.1, -2.0), 0.3)
            .add_transparent((0.0, 0.7, -1.5), 0.2)
            .build(pad_to=7))


def _same(port_scene, jax_scene):
    for f in FIELDS:
        want = np.asarray(getattr(jax_scene, f))
        got = getattr(port_scene, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _same_camera(port_cam, jax_cam):
    for f in ("image_width", "image_height", "samples_per_pixel", "max_depth"):
        assert getattr(port_cam, f) == getattr(jax_cam, f), f
    for f in CAM_FIELDS:
        np.testing.assert_array_equal(getattr(port_cam, f).numpy(),
                                      np.asarray(getattr(jax_cam, f)), err_msg=f)


@pytest.mark.parametrize("ext", ["json", "npz"])
@pytest.mark.parametrize("with_camera", [True, False])
def test_port_file_loads_in_jax(tmp_path, ext, with_camera):
    scene, cam = tp.config3()
    path = str(tmp_path / f"s.{ext}")
    tio.save_scene(path, scene, cam if with_camera else None)
    js, jc = jio.load_scene(path)
    ts, tc = tio.load_scene(path)
    _same(ts, js)
    _same(ts, tp.config3()[0])
    assert (jc is None) == (tc is None) == (not with_camera)
    if with_camera:
        _same_camera(tc, jc)
        _same_camera(tc, cam)


@pytest.mark.parametrize("ext", ["json", "npz"])
@pytest.mark.parametrize("with_camera", [True, False])
def test_jax_file_loads_in_port(tmp_path, ext, with_camera):
    js, jc = jp.config4()
    path = str(tmp_path / f"s.{ext}")
    jio.save_scene(path, js, jc if with_camera else None)
    ts, tc = tio.load_scene(path)
    _same(ts, jio.load_scene(path)[0])
    _same(ts, js)
    assert (tc is None) == (not with_camera)
    if with_camera:
        _same_camera(tc, jc)


def test_json_text_and_npz_entries_equal_jax():
    """The port writes the JAX package's bytes: the same JSON text and
    the same NPZ entries."""
    scene, cam = tp.config2()
    js, jc = jp.config2()
    assert tio.scene_to_json(scene, cam) == jio.scene_to_json(js, jc)
    got = tio._scene_to_npz_dict(scene, cam)
    want = jio._scene_to_npz_dict(js, jc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_custom_scene_roundtrip_both_ways(tmp_path):
    scene = _custom_port_scene()
    d = tio.scene_to_dict(scene, keep_padding=True)
    js, _ = jio.scene_from_dict(d)
    _same(scene, js)
    back, _ = tio.scene_from_dict(jio.scene_to_dict(js, keep_padding=True))
    _same(back, js)


@pytest.mark.parametrize("ext", ["json", "npz"])
def test_padding_dropped_and_restored(tmp_path, ext):
    scene = tp.config5()[0]  # the final scene padded to 512
    n_real = int((scene.radii > 0).sum())
    path = str(tmp_path / f"p.{ext}")
    tio.save_scene(path, scene)
    loaded, _ = tio.load_scene(path)
    if ext == "json":  # JSON drops the padding, NPZ keeps the arrays verbatim
        assert loaded.num_spheres == n_real
        d = tio.scene_to_dict(scene)
        assert len(d["spheres"]) == n_real
    repadded, _ = tio.load_scene(path, pad_to=600)
    js, _ = jio.load_scene(path, pad_to=600)
    _same(repadded, js)
    assert repadded.num_spheres == 600
    if ext == "json":
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(repadded, f)[:512].numpy(),
                                          getattr(scene, f).numpy(), err_msg=f)
    with pytest.raises(ValueError, match="pad_to"):
        tio.load_scene(path, pad_to=3)


def test_load_clamps_like_builder(tmp_path):
    d = {"format": tio.FORMAT, "spheres": [
        {"type": "metal", "center": [0, 0, -1], "radius": -2.0, "albedo": [1, 1, 1],
         "fuzz": 7.5}]}
    scene, _ = tio.scene_from_dict(d)
    assert float(scene.radii[0]) == 0.0 and float(scene.fuzz[0]) == 1.0
    _same(scene, jio.scene_from_dict(d)[0])
    # the NPZ path clamps too
    path = str(tmp_path / "c.npz")
    arrays = {k: np.asarray(v) for k, v in tio._scene_to_npz_dict(scene, None).items()}
    arrays["radii"] = np.asarray([-3.0], np.float32)
    arrays["fuzz"] = np.asarray([9.0], np.float32)
    np.savez(path, **arrays)
    loaded, _ = tio.load_scene(path)
    assert float(loaded.radii[0]) == 0.0 and float(loaded.fuzz[0]) == 1.0
    _same(loaded, jio.load_scene(path)[0])


@pytest.mark.parametrize("bad,msg", [
    ({"format": "nope", "spheres": [{}]}, "not a dray-scene-v1"),
    ({"format": tio.FORMAT, "spheres": []}, "no spheres"),
    ({"format": tio.FORMAT, "spheres": [{"type": "plane", "center": [0, 0, 0], "radius": 1}]},
     "unknown type"),
    ({"format": tio.FORMAT, "spheres": [{"type": "metal", "center": [0, 0, 0]}]},
     "missing required"),
    ({"format": tio.FORMAT, "spheres": [{"type": "metal", "center": [0, 0], "radius": 1}]},
     "3 components"),
])
def test_validation_errors(bad, msg):
    with pytest.raises(ValueError, match=msg):
        tio.scene_from_dict(bad)
    with pytest.raises(ValueError, match=msg):
        jio.scene_from_dict(bad)


def test_unknown_camera_field_rejected():
    with pytest.raises(ValueError, match="unknown camera fields"):
        tio.camera_from_dict({"image_width": 10, "shutter": 0.1})


def test_bad_extension_rejected(tmp_path):
    with pytest.raises(ValueError, match="extension"):
        tio.save_scene(str(tmp_path / "s.txt"), tp.config1()[0])
    with pytest.raises(ValueError, match="extension"):
        tio.load_scene(str(tmp_path / "s.txt"))


def test_job_config_roundtrip_and_build(tmp_path):
    path = str(tmp_path / "scene.json")
    tio.save_scene(path, tp.config2()[0])  # no camera: the preset's
    job = RenderJobConfig(preset="config1", scene_path=path, spp=3, batch=2,
                          camera=CameraConfig(image_width=20, lookfrom=(0.0, 1.0, 2.0)))
    back = RenderJobConfig.from_json(job.to_json())
    assert back.to_json() == job.to_json()
    scene, cam = back.build()
    _same(scene, jp.config2()[0])
    assert cam.image_width == 400 and cam.samples_per_pixel == 3
    # a camera-less file and no preset: the config's own camera
    scene, cam = RenderJobConfig(scene_path=path, camera=CameraConfig(image_width=20)).build()
    assert cam.image_width == 20
    want = make_camera(image_width=20)
    np.testing.assert_array_equal(cam.pixel00_loc.numpy(), want.pixel00_loc.numpy())
    with pytest.raises(ValueError, match="custom scenes"):
        RenderJobConfig().build()


def test_cli_export_then_render_scene(tmp_path):
    """export-scene then render --scene --cpu gives the preset's image
    byte for byte (the mega engine, whose plain version runs here), also
    with the camera left out of the file (the preset's camera then)."""
    from distributed_raytracer_tpu_torch.cli import main

    common = ["--width", "24", "--spp", "2", "--cpu", "--batch", "2"]
    want = str(tmp_path / "preset.ppm")
    main(["render", "--config", "config2", *common, "--out", want])
    ref = open(want, "rb").read()
    for name, extra in (("cam.json", []), ("nocam.npz", ["--no-camera"])):
        scene_file = str(tmp_path / name)
        main(["export-scene", "--config", "config2", *extra, scene_file])
        out = str(tmp_path / (name + ".ppm"))
        main(["render", "--scene", scene_file, "--config", "config2", *common, "--out", out])
        assert open(out, "rb").read() == ref, name
    d = json.loads(open(tmp_path / "cam.json").read())
    assert d["format"] == "dray-scene-v1" and "camera" in d
