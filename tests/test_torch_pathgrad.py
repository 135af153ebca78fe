"""The port's path-replay tracer (grad/pathgrad.py) on the CPU against the
JAX package's, on tests/test_pathgrad.py's scene (24x24, depth 8, rays of
generate_rays with PRNGKey(7), key PRNGKey(3)); the rays go to both sides
as numpy.  JAX runs once per module, in a module fixture.

Bands: the recording forward's draws are JAX's threefry bits (the
uniforms bit for bit, the unit vectors within ROADMAP's "Threefry draws"
band, 1e-6), its records of o, d and atten within 2e-4 (ROADMAP Queue 3:
a scattered ray's next o and d part by up to 1.6e-4 away from grazing
hits; measured 4.4e-5), its colors at the North-star depth-8 band (max
5e-4, mean 5e-6); the backward against autograd of the same recording forward and
the port's gradients against JAX's at test_pathgrad.py:30-57's 2e-5 of
each field's largest value (measured 1.2e-5 against JAX, fuzz; 2.5e-7
against the oracle); the finite-difference checks at test_pathgrad.py's
rtol (0.08 fused primal, 0.1 image grad fn)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.grad import pathgrad as jpg
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.grad import pathgrad as tpg
from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import closest_hit_pallas
from test_pathgrad import setup
from test_torch_scene import to_port

FIELDS = ("centers", "radii", "albedo", "fuzz", "ior")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def case():
    scene, o, d = setup()
    key = jax.random.PRNGKey(3)
    colors, steps = jax.jit(
        lambda s, oo, dd: jpg._forward_scan(s, oo, dd, key, 8, jpg.closest_hit))(scene, o, d)
    fast = jpg.make_pathgrad_tracer(key, 8, pool_divisor=4)
    grads = jax.jit(jax.grad(lambda s, oo, dd: jnp.sum(fast(s, oo, dd) ** 2),
                             argnums=(0, 1, 2), allow_int=True))(scene, o, d)
    return dict(ts=to_port(scene), o=torch.from_numpy(np.array(o)),
                d=torch.from_numpy(np.array(d)), colors=np.asarray(colors),
                steps=jpg._Step(*(np.asarray(x) for x in steps)),
                g=({k: np.asarray(getattr(grads[0], k)) for k in FIELDS},
                   np.asarray(grads[1]), np.asarray(grads[2])))


def _grads(tracer, c):
    """d sum(colors^2) in the five fields and the rays, and the colors."""
    p = {k: getattr(c["ts"], k).clone().requires_grad_() for k in FIELDS}
    o, d = c["o"].clone().requires_grad_(), c["d"].clone().requires_grad_()
    colors = tracer(c["ts"].with_diff_params(p), o, d)
    (colors ** 2).sum().backward()
    return colors.detach(), ({k: v.grad.numpy() for k, v in p.items()}, o.grad.numpy(),
                             d.grad.numpy())


def _close(got, want, atol):
    (gs, go, gd), (ws, wo, wd) = got, want
    for name, a, b in [*((k, gs[k], ws[k]) for k in FIELDS), ("ray_o", go, wo),
                       ("ray_d", gd, wd)]:
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(np.asarray(a) / scale, b / scale, atol=atol, err_msg=name)


def test_forward_scan_matches_jax(case):
    c = case
    colors, steps = tpg._forward_scan(c["ts"], c["o"], c["d"], prng.PRNGKey(3), 8,
                                      tpg.closest_hit)
    js = c["steps"]
    for name in ("idx", "hit", "active"):
        np.testing.assert_array_equal(getattr(steps, name).numpy(), getattr(js, name),
                                      err_msg=name)
    np.testing.assert_array_equal(steps.u.numpy(), js.u)
    np.testing.assert_allclose(steps.ruv.numpy(), js.ruv, rtol=0, atol=1e-6)
    # a scattered ray's next o and d part by up to 1.6e-4 away from grazing
    # hits (XLA:CPU contracts, torch rounds each operation; ROADMAP Queue 3)
    live = js.active
    for name in ("o", "d", "atten"):
        np.testing.assert_allclose(getattr(steps, name).numpy()[live], getattr(js, name)[live],
                                   rtol=1e-4, atol=2e-4, err_msg=name)
    dif = np.abs(colors.numpy() - c["colors"])
    assert dif.max() < 5e-4 and dif.mean() < 5e-6


@pytest.mark.parametrize("pool_divisor", [1, 4])
def test_backward_pool_matches_autograd_oracle(case, pool_divisor):
    c = case
    key = prng.PRNGKey(3)
    fast = tpg.make_pathgrad_tracer(key, 8, pool_divisor=pool_divisor, device="cpu")
    oracle = tpg.make_pathgrad_tracer(key, 8, use_custom_vjp=False, device="cpu")
    cf, gf = _grads(fast, c)
    co, go = _grads(oracle, c)
    assert torch.equal(cf, co)
    _close(gf, go, 2e-5)


def test_grads_match_jax(case):
    c = case
    _, g = _grads(tpg.make_pathgrad_tracer(prng.PRNGKey(3), 8, pool_divisor=4, device="cpu"), c)
    _close(g, c["g"], 2e-5)


def test_wavefront_equals_scan_bit_for_bit(case):
    """The wavefront primal gives the scan's colors and records bit for bit
    (the draws of (ray, bounce) do not depend on the lane; K11's plain
    closest hit computes each ray alone), so the same gradients."""
    c = case
    key = prng.PRNGKey(3)
    s_col, s_st = tpg._forward_scan(c["ts"], c["o"], c["d"], key, 8, closest_hit_pallas)
    w_col, w_st = tpg._forward_wavefront(c["ts"], c["o"], c["d"], key, 8, 100,
                                         closest_hit_pallas)
    assert torch.equal(s_col, w_col)
    live = s_st.active
    for name, a, b in zip(tpg._Step._fields, s_st, w_st):
        assert torch.equal(a[live], b[live]), name
    scan = tpg.make_pathgrad_tracer(key, 8, intersect_fn=closest_hit_pallas, device="cpu")
    wave = tpg.make_pathgrad_tracer(key, 8, intersect_fn=closest_hit_pallas, primal="wavefront",
                                    primal_pool=128, device="cpu")
    cs, gs = _grads(scan, c)
    cw, gw = _grads(wave, c)
    assert torch.equal(cs, cw)
    for k in FIELDS:
        np.testing.assert_allclose(gs[0][k], gw[0][k], rtol=1e-5, atol=1e-6, err_msg=k)
    dif = np.abs(cw.numpy() - c["colors"])
    assert dif.max() < 5e-4 and dif.mean() < 5e-6
    _close(gw, c["g"], 2e-5)


def _two_sphere(width=12, depth=4):
    from test_pathgrad import SceneBuilder, generate_rays, make_camera

    scene = (SceneBuilder()
             .add_lambertian((0, -100.5, -1), 100.0, (0.6, 0.7, 0.2))
             .add_lambertian((0, 0, -1.5), 0.5, (0.7, 0.3, 0.3))
             .build())
    cam = make_camera(aspect_ratio=1.0, image_width=width, max_depth=depth)
    ids = jnp.arange(cam.num_pixels, dtype=jnp.int32)
    o, d = generate_rays(cam, jax.random.PRNGKey(7), ids % width, ids // width)
    return scene, cam, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))


def test_fused_primal_fd_albedo():
    """The fused primal (K10's plain version, its hash draws) with the path
    replay against central differences of the same function
    (test_pathgrad.py:106-131)."""
    scene, _, o, d = _two_sphere()
    ts = to_port(scene)
    f = tpg.make_pathgrad_tracer(prng.PRNGKey(2), 4, primal="fused", device="cpu")

    def loss(v):
        alb = ts.albedo.clone()
        alb[1, 0] = v
        return (f(ts.with_diff_params({"albedo": alb}), o, d) ** 2).sum()

    v = torch.tensor(0.7, requires_grad=True)
    loss(v).backward()
    eps = 1e-2
    fd = (float(loss(torch.tensor(0.7 + eps))) - float(loss(torch.tensor(0.7 - eps)))) / (2 * eps)
    np.testing.assert_allclose(float(v.grad), fd, rtol=0.08, atol=1e-5)
    assert float(v.grad) != 0.0


def test_image_grad_fn_fd_and_jax():
    """make_image_grad_fn (test_pathgrad.py:134-159): its albedo gradient
    against central differences of its own loss, and loss and gradients
    against JAX's on the same seed and samples."""
    scene, _, _, _ = _two_sphere()
    from test_pathgrad import make_camera

    jcam = make_camera(aspect_ratio=1.0, image_width=16, max_depth=6)
    ts, cam = to_port(scene, jcam)
    grad_fn = tpg.make_image_grad_fn(cam, seed=4, device="cpu")
    target = torch.zeros(cam.num_pixels, 3)
    loss, grads = grad_fn(ts, target, [0, 1])
    an = float(grads["albedo"][1, 0])
    assert np.isfinite(float(loss)) and float(loss) > 0 and np.isfinite(an) and an != 0

    def f(v):
        alb = ts.albedo.clone()
        alb[1, 0] = v
        return float(grad_fn(ts.with_diff_params({"albedo": alb}), target, [0, 1])[0])

    eps = 1e-2
    np.testing.assert_allclose(an, (f(0.7 + eps) - f(0.7 - eps)) / (2 * eps), rtol=0.1,
                               atol=1e-5)
    j_loss, j_grads = jpg.make_image_grad_fn(jcam, seed=4)(scene, jnp.zeros((256, 3)), [0, 1])
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    for k in FIELDS:
        b = np.asarray(j_grads[k])
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(grads[k].numpy() / scale, b / scale, atol=2e-5, err_msg=k)


def test_depth_exhausted_rays_zero_grad():
    from test_pathgrad import SceneBuilder

    scene = to_port(SceneBuilder()
                    .add_metal((0, 0, -1002), 1000.0, (0.9, 0.9, 0.9), 0.0)
                    .add_metal((0, 0, 1002), 1000.0, (0.9, 0.9, 0.9), 0.0)
                    .build())
    o = torch.zeros(64, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(64, 1)
    f = tpg.make_pathgrad_tracer(prng.PRNGKey(0), 4, device="cpu")
    p = {k: getattr(scene, k).clone().requires_grad_() for k in FIELDS}
    f(scene.with_diff_params(p), o, d).sum().backward()
    for name in ("centers", "radii", "albedo"):
        g = p[name].grad
        assert torch.isfinite(g).all() and not g.any(), name


def test_unknown_primal_refused():
    with pytest.raises(ValueError, match="unknown primal"):
        tpg.make_pathgrad_tracer(prng.PRNGKey(0), 4, primal="tiled", device="cpu")


@pytest.mark.parametrize("primal", tpg.PRIMALS)
def test_scene_changed_in_place_before_backward_refused(primal):
    """The tracer keeps the scene for its backward through autograd's saved
    tensors: a scene field changed in place between forward and backward
    (an optimizer step on a retained graph) raises, where it would give the
    gradients of another scene."""
    scene, _, o, d = _two_sphere(width=6, depth=3)
    ts = to_port(scene)
    f = tpg.make_pathgrad_tracer(prng.PRNGKey(2), 3, primal=primal, device="cpu")
    p = {k: getattr(ts, k).clone().requires_grad_() for k in FIELDS}
    loss = f(ts.with_diff_params(p), o, d).sum()
    with torch.no_grad():
        p["albedo"].mul_(0.5)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        loss.backward()
