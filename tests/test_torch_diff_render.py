"""The port's differentiable rendering (grad/diff_render.py: render_diff,
scene_grads, scene_and_camera_grads, InverseRenderer; cli.py grad-check
and invert) on the CPU against the JAX package's, on tests/test_grad.py's
setups (the general 3-sphere scene at 24x24 depth 6, the edge-free big
sphere at 16x16 depth 4).  JAX runs once per module, in a module fixture.

Bands: the losses within rtol 1e-5; the albedo gradients within 2e-4 of
the field's largest value; the geometric ones (centers, radii, fuzz)
within 1e-3 of it (measured 1.8e-4: the scan engine's grazing hits,
where XLA:CPU and torch round the discriminant apart, ROADMAP Queue 3);
the pose gradients within rtol 1e-3 and 1e-3 of the largest pose
gradient (measured 3e-6 relative); the finite-difference checks at
test_grad.py:82-205's bands (rtol 0.08 albedo, 0.1 centers, radii and
fuzz, 0.15 pose), the recovery at its 0.08."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.grad import InverseRenderer as JaxInverseRenderer
from distributed_raytracer_tpu.grad import render_diff as jax_render_diff
from distributed_raytracer_tpu.grad import scene_and_camera_grads as jax_scene_and_camera_grads
from distributed_raytracer_tpu.grad import scene_grads as jax_scene_grads
from distributed_raytracer_tpu_torch import cli
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.grad import diff_render as tdr
from distributed_raytracer_tpu_torch.ops.camera import reinitialize
from test_grad import SceneBuilder, edge_free_setup, general_setup, make_camera
from test_torch_renderer import _f64
from test_torch_scene import to_port

FIELDS = ("centers", "radii", "albedo", "fuzz", "ior")
GEOMETRIC_BAND = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def case():
    """JAX's scene_grads on the general setup against its own render of
    another key, and its scene_and_camera_grads on the edge-free one."""
    scene, cam = general_setup()
    s = jnp.arange(4, dtype=jnp.int32)
    target = jax_render_diff(scene, cam, jax.random.PRNGKey(1), s)
    loss, grads = jax_scene_grads(scene, cam, jax.random.PRNGKey(11), s, target)
    e_scene, e_cam = edge_free_setup("lambertian")
    e_loss, (e_sg, e_pg) = jax_scene_and_camera_grads(
        e_scene, e_cam, jax.random.PRNGKey(6), jnp.arange(2, dtype=jnp.int32),
        jnp.zeros((e_cam.num_pixels, 3)))
    return dict(general=to_port(scene, cam), target=np.array(target), loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()},
                edge=to_port(e_scene, e_cam), e_loss=float(e_loss),
                e_sg={k: np.asarray(v) for k, v in e_sg.items()},
                e_pg={k: np.asarray(v) for k, v in e_pg.items()})


def _scene_close(got, want):
    for k in FIELDS:
        b = want[k]
        scale = np.abs(b).max() + 1e-12
        band = 2e-4 if k == "albedo" else GEOMETRIC_BAND
        np.testing.assert_allclose(got[k].numpy() / scale, b / scale, atol=band, err_msg=k)


def test_render_diff_matches_jax(case):
    """The image against JAX's, both held to the port's float64 run on the
    same keys as tests/test_torch_renderer.py holds the scan engine: a
    path that rounding scatters another way parts by far, so the port
    stands within the depth-8 band of float64 on as many pixels as JAX
    less one, and the two agree at the band on the pixels where both do."""
    scene, cam = case["general"]
    got = tdr.render_diff(scene, cam, prng.PRNGKey(1), range(4)).detach().numpy()
    ref = tdr.render_diff(_f64(scene), cam, prng.PRNGKey(1), range(4)).detach().numpy()
    want = case["target"]
    jax_ok = np.abs(want - ref).max(-1) < 5e-4
    port_ok = np.abs(got - ref).max(-1) < 5e-4
    assert port_ok.sum() >= jax_ok.sum() - 1 and jax_ok.mean() > 0.98
    dif = np.abs(got - want)[jax_ok & port_ok]
    assert dif.max() < 5e-4 and dif.mean() < 5e-6


def test_scene_grads_match_jax(case):
    scene, cam = case["general"]
    loss, grads = tdr.scene_grads(scene, cam, prng.PRNGKey(11), range(4),
                                  torch.from_numpy(case["target"]), device="cpu")
    np.testing.assert_allclose(float(loss), case["loss"], rtol=1e-5)
    _scene_close(grads, case["grads"])
    for k in ("albedo", "centers"):
        assert grads[k].abs().max() > 0, k


def test_scene_and_camera_grads_match_jax(case):
    scene, cam = case["edge"]
    loss, (sg, pg) = tdr.scene_and_camera_grads(scene, cam, prng.PRNGKey(6), range(2),
                                                torch.zeros(cam.num_pixels, 3), device="cpu")
    np.testing.assert_allclose(float(loss), case["e_loss"], rtol=1e-5)
    _scene_close(sg, case["e_sg"])
    scale = max(np.abs(v).max() for v in case["e_pg"].values())
    for k in tdr.CAMERA_POSE_FIELDS:
        np.testing.assert_allclose(pg[k].numpy(), case["e_pg"][k], rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=k)
    assert pg["lookfrom"].abs().max() > 0


def central_diff(f, x0, eps):
    return (f(x0 + eps) - f(x0 - eps)) / (2 * eps)


def _fd_case(setup, key, n_samples, field, index, x0, eps, rtol, atol):
    """test_grad.py's finite-difference checks in the port: the analytic
    gradient of one scene entry against central differences of the loss
    on the same key (fixed noise)."""
    scene, cam = to_port(*setup)
    target = torch.zeros(cam.num_pixels, 3)
    k = prng.PRNGKey(key)
    _, grads = tdr.scene_grads(scene, cam, k, range(n_samples), target, device="cpu")

    def f(v):
        arr = getattr(scene, field).clone()
        arr[index] = v
        img = tdr.render_diff(scene.with_diff_params({field: arr}), cam, k, range(n_samples))
        return float(tdr.image_loss(img, target))

    an = float(grads[field][index])
    np.testing.assert_allclose(an, central_diff(f, x0, eps), rtol=rtol, atol=atol)
    return an


@pytest.mark.parametrize("name", ["albedo", "centers", "radii", "fuzz"])
def test_grad_matches_fd(name):
    """test_grad.py:82-144: albedo on the general scene (it moves no edge),
    the geometric fields on edge-free setups."""
    if name == "albedo":
        _fd_case(general_setup(), 11, 4, "albedo", (1, 0), 0.7, 1e-2, 0.08, 1e-5)
    elif name == "centers":
        _fd_case(edge_free_setup("lambertian"), 2, 4, "centers", (0, 2), -3.0, 2e-3, 0.1, 1e-4)
    elif name == "radii":
        _fd_case(edge_free_setup("lambertian"), 3, 4, "radii", (0,), 2.0, 2e-3, 0.1, 1e-4)
    else:
        _fd_case(edge_free_setup("metal"), 4, 4, "fuzz", (0,), 0.3, 5e-3, 0.1, 1e-5)


def test_ior_grad_finite_nonzero():
    scene, cam = to_port(*edge_free_setup("dielectric"))
    _, grads = tdr.scene_grads(scene, cam, prng.PRNGKey(5), range(4),
                               torch.zeros(cam.num_pixels, 3), device="cpu")
    g = float(grads["ior"][0])
    assert np.isfinite(g) and g != 0.0


@pytest.mark.parametrize("field", ["lookfrom", "vfov"])
def test_pose_grad_matches_fd(field):
    """test_grad.py:162-205: a dolly along z and the field of view, both
    edge-free."""
    scene, cam = to_port(*edge_free_setup("lambertian"))
    key = prng.PRNGKey(6 if field == "lookfrom" else 7)
    target = torch.zeros(cam.num_pixels, 3)
    _, (_, pg) = tdr.scene_and_camera_grads(scene, cam, key, range(2), target, device="cpu")

    def f(v):
        if field == "lookfrom":
            lf = cam.lookfrom.clone()
            lf[2] = v
            c = reinitialize(cam.replace(lookfrom=lf))
        else:
            c = reinitialize(cam.replace(vfov=torch.tensor(v, dtype=torch.float32)))
        return float(tdr.image_loss(tdr.render_diff(scene, c, key, range(2)), target))

    if field == "lookfrom":
        fd = central_diff(f, float(cam.lookfrom[2]), 2e-3)
        np.testing.assert_allclose(float(pg["lookfrom"][2]), fd, rtol=0.15, atol=1e-4)
    else:
        fd = central_diff(f, 30.0, 0.05)
        np.testing.assert_allclose(float(pg["vfov"]), fd, rtol=0.15, atol=1e-6)


def _inverse_setup():
    scene = (SceneBuilder()
             .add_lambertian((0, -100.5, -1), 100.0, (0.5, 0.5, 0.5))
             .add_lambertian((0, 0, -1.5), 0.5, (0.8, 0.2, 0.6))
             .build())
    cam = make_camera(aspect_ratio=1.0, image_width=16, samples_per_pixel=4, max_depth=4)
    start = scene.replace(albedo=scene.albedo.at[1].set(jnp.asarray([0.3, 0.7, 0.2])))
    return scene, cam, start


def test_inverse_renderer_recovers_albedo():
    """test_grad.py:208-229 at 16x16: Adam on the scan engine recovers a
    perturbed albedo within 0.08."""
    scene, cam, start = _inverse_setup()
    ts, tc = to_port(scene, cam)
    target = tdr.render_diff(ts, tc, prng.PRNGKey(123), range(8)).detach()
    inv = tdr.InverseRenderer(to_port(start), tc, target, fields=("albedo",),
                              learning_rate=5e-2, spp_per_step=4, device="cpu")
    first = inv.step()
    for _ in range(150):
        last = inv.step()
    assert last < first * 0.35, (first, last)
    np.testing.assert_allclose(inv.scene.albedo[1].numpy(), [0.8, 0.2, 0.6], atol=0.08)


@pytest.mark.parametrize("engine", ["scan", "tape"])
def test_inverse_renderer_steps_match_jax(engine):
    """The first three steps of both engines against JAX's InverseRenderer
    on the CPU (the tape engine without the fused bounce there, as JAX's
    off the TPU): the losses within rtol 1e-4 and the albedo after them
    within 1e-5 (Adam's steps are lr-sized whatever the gradient's scale,
    so the albedo carries the gradients' signs and ratios)."""
    scene, cam, start = _inverse_setup()
    target = jax_render_diff(scene, cam, jax.random.PRNGKey(123), jnp.arange(8, dtype=jnp.int32))
    kw = dict(fields=("albedo",), learning_rate=5e-2, spp_per_step=2, engine=engine, pool=64)
    jinv = JaxInverseRenderer(start, cam, target, **kw)
    ts, tc = to_port(start, cam)
    inv = tdr.InverseRenderer(ts, tc, torch.from_numpy(np.array(target)), device="cpu", **kw)
    for _ in range(3):
        np.testing.assert_allclose(inv.step(), jinv.step(), rtol=1e-4)
    np.testing.assert_allclose(inv.scene.albedo.numpy(), np.asarray(jinv.scene.albedo),
                               rtol=0, atol=1e-5)


def test_cli_grad_check_and_invert(capsys):
    cli.main(["grad-check", "--config", "config1", "--width", "16", "--cpu"])
    err = capsys.readouterr().err
    assert "loss:" in err and "d/dalbedo" in err and "finite=True" in err
    assert "finite=False" not in err
    cli.main(["invert", "--config", "config1", "--width", "16", "--steps", "2", "--cpu"])
    err = capsys.readouterr().err
    assert "step 0: loss" in err and "final albedo MAE" in err
