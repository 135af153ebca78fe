"""The port's reference bounce (ops/materials.py, ops/trace.py) against the
JAX package's, on the CPU, on the same threefry keys.

scatter with the draws handed in: within 1e-6.  bounce_step on the same
key (the port draws JAX's threefry numbers, core/prng.py): colors and
attenuations within 1e-6, the next rays within 1e-5 relative (their
start o + t d carries the expanded quadratic's t, which XLA:CPU's and
torch's matmuls round apart; measured 5.2e-6).  trace_rays on the same
key: depth 1 within 1e-6 on every ray; depth 8 at the
test_mega_render.py bands (max < 5e-4, mean < 5e-6) on every ray where
JAX and the port both stand within them of the float64 referee (the
port's own trace in float64 on the same draws), and the port within them
of float64 on at least as many rays as JAX.  On the final scene a few
rays part (32x18: JAX and the port each stand within the band of float64
on 570 of 576, both outside it on 4, each alone on 2; on config2 JAX on
575, the port on all 576): the R = 1000 ground sphere's expanded quadratic
cancels at |c|^2 ~ 1e6, where XLA:CPU's matmul and torch's round apart,
and a path then scatters another way.
A gradient of trace_rays (albedo, centers, radii, rays) against jax.grad
on a tiny case, normalized by its max, within 2e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.ops import materials as jmat
from distributed_raytracer_tpu.ops import trace as jtrace
from distributed_raytracer_tpu.ops.camera import generate_rays as jax_generate_rays
from distributed_raytracer_tpu.ops.camera import make_camera as jax_make_camera
from distributed_raytracer_tpu.ops.intersect import closest_hit as jax_closest_hit
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.ops import materials, trace
from test_torch_scene import to_port

torch.set_num_threads(1)
BAND_MAX, BAND_MEAN = 5e-4, 5e-6


def _f64(scene):
    return dataclasses.replace(scene, **{k: getattr(scene, k).double() for k in
                                         ("centers", "radii", "albedo", "fuzz", "ior")})


def small_camera(cam, width):
    """The camera re-derived at another width (the CLI's --width)."""
    return jax_make_camera(
        aspect_ratio=cam.image_width / cam.image_height, image_width=width,
        samples_per_pixel=cam.samples_per_pixel, max_depth=cam.max_depth,
        vfov=float(cam.vfov), lookfrom=tuple(float(x) for x in cam.lookfrom),
        lookat=tuple(float(x) for x in cam.lookat), vup=tuple(float(x) for x in cam.vup),
        defocus_angle=float(cam.defocus_angle), focus_dist=float(cam.focus_dist))


def _camera_rays(name, width, seed=5):
    scene, cam = (jp.rtiow_final_scene(seed=0, pad_to=512), jp.final_scene_camera(width)) \
        if name == "final" else jp.get_config(name)
    cam = small_camera(cam, width)
    n = cam.image_width * cam.image_height
    ids = jnp.arange(n, dtype=jnp.int32)
    o, d = jax_generate_rays(cam, jax.random.PRNGKey(seed), ids % cam.image_width,
                             ids // cam.image_width)
    return scene, np.array(o), np.array(d)


@pytest.fixture(scope="module", params=["config2", "final"])
def traced(request):
    """Depth 1 and 8 through JAX's trace_rays on 32x18 camera rays."""
    scene, o, d = _camera_rays(request.param, 32)
    key = jax.random.PRNGKey(9)
    want = {depth: np.asarray(jtrace.trace_rays(scene, jnp.asarray(o), jnp.asarray(d), key,
                                                depth)) for depth in (1, 8)}
    return request.param, scene, o, d, want


def test_scatter_with_draws_matches_jax():
    scene, o, d = _camera_rays("final", 32)
    ts = to_port(scene)
    res = jax_closest_hit(jnp.asarray(o), jnp.asarray(d), scene)
    t = np.where(np.asarray(res.hit), np.asarray(res.t), 1.0).astype(np.float32)
    idx = np.asarray(res.idx)
    rng = np.random.default_rng(4)
    ruv = rng.normal(size=(o.shape[0], 3))
    ruv = (ruv / np.linalg.norm(ruv, axis=1, keepdims=True)).astype(np.float32)
    u = rng.random(o.shape[0]).astype(np.float32)
    want = jmat.scatter(None, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(idx),
                        scene, draws=(jnp.asarray(ruv), jnp.asarray(u)))
    got = materials.scatter(None, torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(t), torch.from_numpy(idx), ts,
                            draws=(torch.from_numpy(ruv), torch.from_numpy(u)))
    for k in ("origin", "direction", "attenuation"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got.scattered.numpy(), np.asarray(want.scattered))


def test_bounce_step_matches_jax():
    scene, o, d = _camera_rays("config2", 32)
    key = jax.random.PRNGKey(11)
    want = jtrace.bounce_step(jtrace.init_state(jnp.asarray(o), jnp.asarray(d)), key, scene)
    got = trace.bounce_step(trace.init_state(torch.from_numpy(o), torch.from_numpy(d)),
                            prng.PRNGKey(11), to_port(scene))
    for k in ("attenuation", "color"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    # the next ray starts at o + t d: the expanded quadratic's t rounds apart
    # in XLA:CPU's matmul and torch's (measured 5.2e-6 relative)
    for k in ("origin", "direction"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))


def test_trace_rays_matches_jax(traced):
    name, scene, o, d, want = traced
    ts = to_port(scene)
    key = prng.PRNGKey(9)
    got1 = trace.trace_rays(ts, torch.from_numpy(o), torch.from_numpy(d), key, 1).numpy()
    assert np.abs(got1 - want[1]).max() < 1e-6
    got = trace.trace_rays_fast(ts, torch.from_numpy(o), torch.from_numpy(d), key, 8).numpy()
    ref = trace.trace_rays_fast(_f64(ts), torch.from_numpy(o).double(),
                                torch.from_numpy(d).double(), key, 8).numpy()
    jax_ok = np.abs(want[8] - ref).max(-1) < BAND_MAX
    port_ok = np.abs(got - ref).max(-1) < BAND_MAX
    assert port_ok.sum() >= jax_ok.sum() >= 0.98 * len(ref), (name, port_ok.sum(), jax_ok.sum())
    diff = np.abs(got - want[8])[jax_ok & port_ok]
    assert diff.max() < BAND_MAX and diff.mean() < BAND_MEAN, (name, diff.max(), diff.mean())


def test_trace_rays_gradient_matches_jax():
    scene, o, d = _camera_rays("config2", 16)  # 144 rays, most of them hit
    w = np.random.default_rng(2).random(o.shape).astype(np.float32)
    key = jax.random.PRNGKey(4)

    def jloss(albedo, centers, radii, oo, dd):
        s = scene.replace(albedo=albedo, centers=centers, radii=radii)
        return jnp.sum(jtrace.trace_rays(s, oo, dd, key, 4) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(scene.albedo, scene.centers, scene.radii,
                                                   jnp.asarray(o), jnp.asarray(d))
    ts = to_port(scene)
    params = [x.clone().requires_grad_() for x in (ts.albedo, ts.centers, ts.radii)]
    oo = torch.from_numpy(o).requires_grad_()
    dd = torch.from_numpy(d).requires_grad_()
    s = ts.with_diff_params(dict(albedo=params[0], centers=params[1], radii=params[2]))
    (trace.trace_rays(s, oo, dd, prng.PRNGKey(4), 4) * torch.from_numpy(w)).sum().backward()
    for x, wv, name in zip(params + [oo, dd], want, ("albedo", "centers", "radii", "o", "d")):
        wv = np.asarray(wv)
        scale = np.abs(wv).max() + 1e-6
        np.testing.assert_allclose(x.grad.numpy() / scale, wv / scale, rtol=0, atol=2e-4,
                                   err_msg=name)
