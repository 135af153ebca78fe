"""The port's scan and reference wavefront engines against the JAX
package's, on the CPU, at 32x18 on config2 and on the RTiOW final scene,
depth 8, on the same seed: render_image (the scan engine) and
render_image_wavefront with the dense closest hit, with K11 (use_pallas)
and with the culled K12 and K13 (make_culled_intersect, tiled ray
order), JAX's Pallas kernels in interpret mode, each run once per module.

The port draws JAX's threefry numbers (core/prng.py), so the images are
held pixel by pixel at the test_mega_render.py depth-8 bands (max < 5e-4,
mean < 5e-6), against JAX and against the float64 referee (the port's
own engine run in float64 on the same keys):

- config2: every pixel of every engine, both sides within the bands of
  each other and of float64 (measured 3.6e-6 at most);
- the final scene, where a few paths part: the R = 1000 ground sphere's
  quadratic cancels at |c|^2 ~ 1e6, XLA:CPU and torch round it apart, and
  the path scatters another way.  The scan engine: every pixel where both
  sides stand within the band of float64, the port so on at least as many
  pixels as JAX less one (measured 570 and 569 of 576).  The wavefront
  engines: their lanes draw by pool position, so a path whose length
  changes re-deals the draws of every later ray, and the float64 run
  (whose path lengths part more) stands within the band on only 72% of
  the pixels for both sides alike (measured 417-419 of 576, within two of
  each other).  There the port is held to JAX at the bands on all but 1%
  of the pixels (measured 3-4 of 576 part, by up to 0.057), and to the
  float64 run on as many pixels as JAX less two.

Within the port: render_progressive(engine="scan"|"wavefront") resumes bit
for bit at the same batch size, and the scan engine's sum over another
batch split equals it to float32 summation order; the CLI runs both
engines, K11 and the culled intersect with --cpu."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.ops.pallas import culled_kernel as jck
from distributed_raytracer_tpu.render import renderer as jrenderer
from distributed_raytracer_tpu.render import wavefront as jwf
from distributed_raytracer_tpu_torch import cli
from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
from distributed_raytracer_tpu_torch.render import progressive, renderer, wavefront
from distributed_raytracer_tpu_torch.render.image import read_ppm
from test_torch_scene import to_port
from test_torch_trace import small_camera

torch.set_num_threads(1)
BAND_MAX, BAND_MEAN = 5e-4, 5e-6
SEED, POOL = 3, 256
ENGINES = ("scan", "dense", "pallas", "grid", "walk")


def _f64(scene):
    return dataclasses.replace(scene, **{k: getattr(scene, k).double() for k in
                                         ("centers", "radii", "albedo", "fuzz", "ior")})


def _run(engine, scene, cam, culled, jax_side):
    """One engine's image: JAX's (jax_side) or the port's."""
    if engine == "scan":
        fn = jrenderer.render_image if jax_side else renderer.render_image
        kw = {} if jax_side else dict(device="cpu")
        return fn(scene, cam, seed=SEED, spp=1, **kw)
    fn = jwf.render_image_wavefront if jax_side else wavefront.render_image_wavefront
    kw = dict(seed=SEED, spp=1, pool_size=POOL)
    if not jax_side:
        kw["device"] = "cpu"
    if engine == "pallas":
        kw["use_pallas"] = True
    elif engine in ("grid", "walk"):
        mci = jck.make_culled_intersect if jax_side else ck.make_culled_intersect
        kw.update(intersect_fn=mci(culled, mode=engine), ray_order="tiled")
        scene = culled.scene
    return fn(scene, cam, **kw)


@pytest.fixture(scope="module", params=["config2", "final"])
def jax_images(request):
    if request.param == "final":
        scene = jp.rtiow_final_scene(seed=0, pad_to=512)
        cam = jp.final_scene_camera(32).replace(max_depth=8)
    else:
        scene, cam = jp.get_config("config2")
        cam = small_camera(cam, 32).replace(max_depth=8)
    culled = jck.build_culled_scene(scene, chunk=128)
    with pltpu.force_tpu_interpret_mode():
        images = {e: np.asarray(_run(e, scene, cam, culled, True)) for e in ENGINES}
    return request.param, scene, cam, images


def _held(diff):
    return diff.max(initial=0.0) < BAND_MAX and diff.mean() < BAND_MEAN


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_jax(jax_images, engine):
    name, scene, cam, images = jax_images
    ts, tc = to_port(scene, cam)
    culled = ck.build_culled_scene(ts, chunk=128)
    got = _run(engine, ts, tc, culled, False)
    ref = _run(engine, _f64(ts), tc, culled._replace(scene=_f64(culled.scene)), False)
    want = images[engine]
    assert got.shape == want.shape == (18, 32, 3) and got.dtype == np.float32
    jax_ok = np.abs(want - ref).max(-1) < BAND_MAX
    port_ok = np.abs(got - ref).max(-1) < BAND_MAX
    diff = np.abs(got - want)
    if name == "config2":
        assert jax_ok.all() and port_ok.all() and _held(diff), (engine, diff.max())
    elif engine == "scan":
        assert port_ok.sum() >= jax_ok.sum() - 1 and jax_ok.mean() > 0.98, \
            (engine, int(port_ok.sum()), int(jax_ok.sum()))
        assert _held(diff[jax_ok & port_ok]), engine
    else:
        assert port_ok.sum() >= jax_ok.sum() - 2, (engine, int(port_ok.sum()), int(jax_ok.sum()))
        close = diff.max(-1) < BAND_MAX
        assert close.mean() >= 0.99 and _held(diff[close]), (engine, int((~close).sum()))


def test_culled_engines_equal_the_dense_one():
    """Over the culled scene, K11 and the culled K12/K13 trace the same
    winners: one image, bit for bit."""
    scene, cam = to_port(jp.rtiow_final_scene(seed=0), jp.final_scene_camera(24).replace(
        max_depth=4))
    culled = ck.build_culled_scene(scene, chunk=128)
    kw = dict(seed=1, spp=1, pool_size=128, ray_order="tiled", device="cpu")
    dense = wavefront.render_image_wavefront(culled.scene, cam, use_pallas=True, **kw)
    for mode in ("grid", "walk"):
        got = wavefront.render_image_wavefront(
            culled.scene, cam, intersect_fn=ck.make_culled_intersect(culled, mode=mode), **kw)
        np.testing.assert_array_equal(got, dense)


@pytest.mark.parametrize("engine", ["scan", "wavefront"])
def test_progressive_resume_is_bit_identical(tmp_path, engine):
    scene, cam = to_port(*jp.get_config("config2"))
    from distributed_raytracer_tpu_torch.ops.camera import make_camera

    cam = make_camera(aspect_ratio=16 / 9, image_width=24, max_depth=6,
                      lookfrom=tuple(cam.lookfrom.tolist()), lookat=tuple(cam.lookat.tolist()),
                      vfov=float(cam.vfov))
    kw = dict(seed=5, engine=engine, device="cpu", pool_size=128)
    whole = progressive.render_progressive(scene, cam, spp=4, batch=2, **kw)
    ckpt = str(tmp_path / "c.npz")
    progressive.render_progressive(scene, cam, spp=2, batch=2, checkpoint_path=ckpt, **kw)
    resumed = progressive.render_progressive(scene, cam, spp=4, batch=2, checkpoint_path=ckpt,
                                             **kw)
    assert resumed.samples_done == 4 and resumed.engine == engine
    np.testing.assert_array_equal(resumed.raw_sum, whole.raw_sum)
    if engine == "scan":
        # each sample is keyed by its index, so another batch split (of
        # render_progressive or of render_image) sums the same samples, in
        # float32 in another order
        img = renderer.render_image(scene, cam, seed=5, spp=4, batch=3, device="cpu")
        np.testing.assert_allclose(whole.mean_image(), img, rtol=1e-6, atol=1e-7)
        one = progressive.render_progressive(scene, cam, spp=4, batch=1, **kw)
        np.testing.assert_allclose(one.raw_sum, whole.raw_sum, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("args", [["--engine", "scan"], ["--engine", "wavefront", "--pallas"],
                                  ["--engine", "wavefront", "--accel", "culled"]])
def test_cli_renders_on_the_cpu(tmp_path, args):
    out = tmp_path / "x.ppm"
    cli.main(["render", "--config", "config5", "--width", "24", "--spp", "1", "--cpu",
              "--out", str(out), *args])
    img = read_ppm(str(out))
    assert img.shape == (13, 24, 3)
    assert img[0, 12, 2] > img[0, 12, 0]  # sky-blue top row
    assert jax.numpy is not None  # both frameworks share the process
