"""The port's data model against the JAX package: presets array-equal,
the 24-float camera row within 1 ulp, numpy round-trips exact.

Also holds the helpers the other test_torch_* files use to carry a JAX
scene or camera into the port."""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.ops.pallas.mega_render_kernel import (
    camera_scalar_row as jax_camera_row,
)
from distributed_raytracer_tpu_torch.models import presets as tp
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import (
    Camera,
    camera_scalar_row,
    generate_rays,
    make_camera,
    reinitialize,
)

torch.set_num_threads(1)

SCENE_FIELDS = ("centers", "radii", "albedo", "mat_type", "fuzz", "ior")


def scene_arrays(jax_scene):
    return {k: np.asarray(getattr(jax_scene, k)) for k in SCENE_FIELDS}


def camera_arrays(jax_camera):
    return {f.name: np.asarray(getattr(jax_camera, f.name))
            for f in dataclasses.fields(jax_camera)}


def to_port(jax_scene, jax_camera=None):
    """A JAX scene (and camera) as the port's CPU objects."""
    scene = Scene.from_numpy(scene_arrays(jax_scene), "cpu")
    if jax_camera is None:
        return scene
    return scene, Camera.from_numpy(camera_arrays(jax_camera), "cpu")


def _assert_scene_equal(jax_scene, port_scene):
    for k in SCENE_FIELDS:
        want = np.asarray(getattr(jax_scene, k))
        got = getattr(port_scene, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4", "config5"])
def test_config_presets_array_equal(name):
    js, jc = jp.get_config(name)
    ts, tc = tp.get_config(name)
    _assert_scene_equal(js, ts)
    assert (tc.image_width, tc.image_height, tc.samples_per_pixel, tc.max_depth) == (
        jc.image_width, jc.image_height, jc.samples_per_pixel, jc.max_depth)


@pytest.mark.parametrize("make", [
    lambda m: m.rtiow_final_scene(pad_to=512),
    lambda m: m.rtiow_final_scene(seed=3, include_features=False),
    lambda m: m.random_sphere_field(600, seed=5),
], ids=["final_pad512", "final_no_features", "field600"])
def test_scene_presets_array_equal(make):
    _assert_scene_equal(make(jp), make(tp))


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("which", ["final1200", "defocus0"])
def test_camera_row_within_one_ulp(which):
    if which == "final1200":
        jc, tc = jp.final_scene_camera(1200), tp.final_scene_camera(1200)
    else:
        kw = dict(aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=4,
                  max_depth=8, vfov=35.0, lookfrom=(-2.0, 2.0, 1.0),
                  lookat=(0.0, 0.0, -1.0), defocus_angle=0.0, focus_dist=3.4)
        jc, tc = jp.make_camera(**kw), make_camera(**kw)
    want = np.asarray(jax_camera_row(jc)).reshape(24)
    got = camera_scalar_row(tc).numpy()
    assert _ulp_diff(got, want).max() <= 1


def test_scene_numpy_round_trip():
    js = jp.rtiow_final_scene(pad_to=512)
    ts = to_port(js)
    back = Scene.from_numpy(ts.to_numpy(), "cpu")
    for k in SCENE_FIELDS:
        assert torch.equal(getattr(back, k), getattr(ts, k)), k
    params = ts.diff_params()
    assert set(params) == {"centers", "radii", "albedo", "fuzz", "ior"}
    moved = ts.with_diff_params({"radii": params["radii"] * 2.0})
    assert torch.equal(moved.radii, ts.radii * 2.0)
    assert torch.equal(moved.mat_type, ts.mat_type)


def test_camera_numpy_round_trip():
    jc = jp.final_scene_camera(400)
    _, tc = to_port(jp.config1()[0], jc)
    for f in dataclasses.fields(jc):
        want = np.asarray(getattr(jc, f.name))
        got = getattr(tc, f.name)
        got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    back = Camera.from_numpy(tc.to_numpy(), "cpu")
    assert torch.equal(camera_scalar_row(back), camera_scalar_row(tc))
    # re-deriving from the carried pose reproduces the derived fields
    again = reinitialize(tc)
    assert _ulp_diff(camera_scalar_row(again).numpy(),
                     camera_scalar_row(tc).numpy()).max() <= 1


def test_builder_padding_and_clamps():
    from distributed_raytracer_tpu_torch.models.scene import ABSORB, SceneBuilder

    s = (SceneBuilder().add_metal((1.0, 2.0, 3.0), -1.0, (0.5, 0.5, 0.5), 3.0)
         .build(pad_to=4))
    assert s.num_spheres == 4
    assert float(s.radii[0]) == 0.0 and float(s.fuzz[0]) == 1.0
    assert s.mat_type[1:].tolist() == [ABSORB] * 3
    assert s.radii[1:].tolist() == [0.0] * 3 and s.ior[1:].tolist() == [1.0] * 3
    with pytest.raises(ValueError):
        SceneBuilder().build()


def test_generate_rays_matches_jax():
    from distributed_raytracer_tpu.ops.camera import generate_rays as jax_generate_rays
    import jax
    import jax.numpy as jnp

    jc = jp.final_scene_camera(64)
    _, tc = to_port(jp.config1()[0], jc)
    rng = np.random.default_rng(0)
    n = 256
    i = rng.integers(0, 64, n).astype(np.int32)
    j = rng.integers(0, 36, n).astype(np.int32)
    draws = [rng.random(n).astype(np.float32) for _ in range(4)]
    jo, jd = jax_generate_rays(jc, jax.random.PRNGKey(0), jnp.asarray(i), jnp.asarray(j),
                               draws=tuple(jnp.asarray(x) for x in draws))
    to, td = generate_rays(tc, torch.from_numpy(i), torch.from_numpy(j),
                           tuple(torch.from_numpy(x) for x in draws))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
